"""K6: HSTU's pointwise attention on the jagged token layout.

A batch's tokens are packed session after session, each session's
history tokens (0..L-1) and then its candidate tokens: q / k [N, H, Dqk]
and v [N, H, Dv] bfloat16, `offsets` [S + 1] int32 (session s holds tokens
offsets[s] .. offsets[s + 1] - 1), `n_hist` [S] int32 (L of each session)
and `ts` [N] int32 (each token's timestamp; a candidate carries its
session's last). For every session, head and query token i:

    y[i] = sum_j bf16(silu(q_i . k_j + w_pos[pos_i - pos_j]
                           + w_time[bucket(|ts_i - ts_j|)]) / n_scale) * v_j

over the keys j the target-aware mask allows: a history token attends the
history tokens j <= i, a candidate attends every history token and itself,
and nothing attends another candidate. A history token sits at its index,
every candidate at L. `bucket(x)` is the largest b with thr[b] <= x
(`time_bucket_thresholds`: min(floor(ln(max(x, 1)) / 0.301), n_buckets)
on whole seconds). The products take bfloat16 operands and sum in float32;
the score, its biases and SiLU are float32; y is float32 [N, H, Dv].

The CUDA kernel is `otto_tpu_torch/csrc/hstu_attention.cu` (one launch
for every session, head and query tile, no score tensor in memory);
`hstu_attention_ref` is its plain PyTorch twin, which a CPU tensor runs.
The kernel sums in another order than the twin, so the two agree to
float32 rounding, not bit for bit.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from otto_tpu_torch.ops.kernels import _build
from otto_tpu_torch.utils import timing

# kernel launches since the last reset (see gather.LAUNCHES)
LAUNCHES = timing.counter("otto::kernels.hstu_attention")

# query rows a block (hstu_attention.cu BM); the kernel's head width
QUERY_ROWS = 64
HEAD_DIM = 64
# bias tables a block holds in shared memory (hstu_attention.cu MAX_POS /
# MAX_BUCKETS)
MAX_POS = 1024
MAX_BUCKETS = 256
# the divisor of ln(|dt|) in the time buckets (log10(2) rounded: buckets e^0.301
# ~ 1.35 apart), as the public HSTU code has it
BUCKET_LOG = 0.301
# elements of the twin's gathered keys per chunk of query rows
_TWIN_BUDGET = 1 << 24


def _bucket_of(x: int) -> int:
    return int(math.floor(math.log(max(x, 1)) / BUCKET_LOG))


def time_bucket_thresholds(n_buckets: int, device=None) -> torch.Tensor:
    """[n_buckets + 1] int64: thr[b] is the least whole number of seconds x
    with floor(ln(max(x, 1)) / 0.301) >= b (thr[0] = 0), so that bucket(x)
    = largest b with thr[b] <= x = min(floor(ln(max(x, 1)) / 0.301),
    n_buckets), the formula taken in float64."""
    thr = [0]
    for b in range(1, n_buckets + 1):
        x = max(1, math.ceil(math.exp(BUCKET_LOG * b)))
        while x > 1 and _bucket_of(x - 1) >= b:
            x -= 1
        while _bucket_of(x) < b:
            x += 1
        thr.append(min(x, 2**62))
    return torch.tensor(thr, dtype=torch.int64, device=device)


def time_bucket(dt: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """Buckets of |dt| (int64 seconds) under `thr`."""
    return torch.searchsorted(thr, dt.abs(), right=True) - 1


def _check(q, k, v, offsets, n_hist, ts, w_pos, w_time, thr):
    tensors = {"q": q, "k": k, "v": v, "offsets": offsets, "n_hist": n_hist, "ts": ts,
               "w_pos": w_pos, "w_time": w_time, "thr": thr}
    want = {"q": torch.bfloat16, "k": torch.bfloat16, "v": torch.bfloat16,
            "offsets": torch.int32, "n_hist": torch.int32, "ts": torch.int32,
            "w_pos": torch.float32, "w_time": torch.float32, "thr": torch.int64}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"hstu_attention: {name} is not a tensor")
        if t.dtype != want[name]:
            raise TypeError(f"hstu_attention: {name} is {t.dtype}, want {want[name]}")
    if q.dim() != 3 or k.shape != q.shape or v.dim() != 3 or v.shape[:2] != q.shape[:2]:
        raise ValueError(
            f"hstu_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            "are not [N, H, Dqk], [N, H, Dqk], [N, H, Dv]")
    N = q.shape[0]
    if (offsets.dim() != 1 or n_hist.dim() != 1 or offsets.shape[0] != n_hist.shape[0] + 1
            or ts.shape != (N,)):
        raise ValueError(
            f"hstu_attention: offsets {tuple(offsets.shape)}, n_hist {tuple(n_hist.shape)}, "
            f"ts {tuple(ts.shape)} are not [S + 1], [S], [N = {N}]")
    if w_pos.dim() != 1 or w_time.dim() != 1 or thr.shape != w_time.shape or w_pos.numel() < 1:
        raise ValueError(
            f"hstu_attention: w_pos {tuple(w_pos.shape)}, w_time {tuple(w_time.shape)}, thr "
            f"{tuple(thr.shape)} are not [P >= 1], [B + 1], [B + 1]")
    for name in ("q", "k", "v"):
        t = tensors[name]
        if t.stride(2) != 1 or t.stride(1) != t.shape[2]:
            raise ValueError(f"hstu_attention: {name}'s heads are not dense "
                             f"(strides {t.stride()})")
    if len({q.stride(0), k.stride(0), v.stride(0)}) != 1:
        raise ValueError("hstu_attention: q, k and v have different row strides "
                         f"({q.stride(0)}, {k.stride(0)}, {v.stride(0)})")
    for name in ("offsets", "n_hist", "ts", "w_pos", "w_time", "thr"):
        if not tensors[name].is_contiguous():
            raise ValueError(f"hstu_attention: {name} is not contiguous")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"hstu_attention: tensors on more than one device: "
                         f"{sorted(map(str, devices))}")


def check_layout(offsets, n_hist, N: int, n_pos: int) -> None:
    """The jagged layout's contents (one sync on a card): offsets start at
    0, never fall and end at N; 0 <= n_hist[s] <= the session's tokens and
    n_hist[s] <= n_pos - 1 (a candidate's position must have a bias)."""
    off = offsets.long()
    T = off[1:] - off[:-1]
    L = n_hist.long()
    bad = torch.stack([off[0] != 0, off[-1] != N, (T < 0).any(), (L < 0).any(),
                       (L > T).any(), (L > n_pos - 1).any()]).cpu()
    names = ("offsets[0] != 0", f"offsets[-1] != N = {N}", "offsets fall",
             "n_hist < 0", "n_hist above a session's tokens",
             f"n_hist above the {n_pos - 1} positions w_pos covers")
    wrong = [n for n, b in zip(names, bad.tolist()) if b]
    if wrong:
        raise ValueError("hstu_attention: bad jagged layout: " + ", ".join(wrong))


def hstu_attention_ref(q, k, v, offsets, n_hist, ts, w_pos, w_time, thr,
                       n_scale: float) -> torch.Tensor:
    """Plain twin: each chunk of query rows gathers its session's history
    keys, padded to the batch's longest history and masked; every row is
    computed alone. The candidates' own key is added after the history's."""
    _check(q, k, v, offsets, n_hist, ts, w_pos, w_time, thr)
    N, H, Dqk = q.shape
    Dv = v.shape[2]
    dev = q.device
    check_layout(offsets, n_hist, N, w_pos.shape[0])
    y = torch.zeros((N, H, Dv), dtype=torch.float32, device=dev)
    S = n_hist.shape[0]
    if N == 0 or S == 0:
        return y
    off = offsets.long()
    L = n_hist.long()
    sess = torch.repeat_interleave(torch.arange(S, device=dev), off[1:] - off[:-1])
    r = torch.arange(N, device=dev) - off[sess]
    tsl = ts.long()
    qf, kf, vf = q.float(), k.float(), v.float()
    Lmax = int(L.max())
    if Lmax > 0:
        j = torch.arange(Lmax, device=dev)
        step = max(1, _TWIN_BUDGET // (Lmax * H * max(Dqk, Dv)))
        for c0 in range(0, N, step):
            rows = torch.arange(c0, min(N, c0 + step), device=dev)
            s_, r_ = sess[rows], r[rows]
            L_ = L[s_]
            kvalid = j[None, :] < L_[:, None]
            key = torch.where(kvalid, off[s_][:, None] + j[None, :], 0)
            is_h = r_ < L_
            allowed = kvalid & (~is_h[:, None] | (j[None, :] <= r_[:, None]))
            sc = torch.einsum("nhd,nlhd->nhl", qf[rows], kf[key])
            pos = torch.where(is_h, r_, L_)
            pidx = (pos[:, None] - j[None, :]).clamp(0, w_pos.shape[0] - 1)
            bkt = time_bucket(tsl[rows][:, None] - tsl[key], thr)
            sc = sc + w_pos[pidx][:, None, :]
            sc = sc + w_time[bkt][:, None, :]
            a = torch.where(allowed[:, None, :], F.silu(sc) / n_scale, 0.0)
            a = a.to(torch.bfloat16).float()
            y[rows] = torch.einsum("nhl,nlhd->nhd", a, vf[key])
    cand = r >= L[sess]
    s_self = (qf * kf).sum(-1) + w_pos[0]
    s_self = s_self + w_time[0]
    a_self = (F.silu(s_self) / n_scale).to(torch.bfloat16).float()
    return y + torch.where(cand[:, None], a_self, 0.0)[..., None] * vf


def hstu_attention(q, k, v, offsets, n_hist, ts, w_pos, w_time, thr,
                   n_scale: float) -> torch.Tensor:
    """y [N, H, Dv] float32. A CPU tensor runs the twin; a CUDA tensor one
    launch of the kernel on the current stream (Dqk = Dv = HEAD_DIM, each
    token's q, k and v rows 16-byte aligned, at most MAX_POS position and
    MAX_BUCKETS time biases). The kernel trusts the layout's contents:
    check_layout validates them (a sync)."""
    _check(q, k, v, offsets, n_hist, ts, w_pos, w_time, thr)
    if q.device.type == "cpu":
        return hstu_attention_ref(q, k, v, offsets, n_hist, ts, w_pos, w_time, thr, n_scale)
    if q.device.type != "cuda":
        raise ValueError(f"hstu_attention: no kernel for {q.device}")
    N, H, D = q.shape
    if D != HEAD_DIM or v.shape[2] != HEAD_DIM:
        raise ValueError(f"hstu_attention: the kernel takes {HEAD_DIM}-wide heads, "
                         f"not Dqk = {D}, Dv = {v.shape[2]}")
    if w_pos.shape[0] > MAX_POS or w_time.shape[0] > MAX_BUCKETS:
        raise ValueError(f"hstu_attention: {w_pos.shape[0]} position / {w_time.shape[0]} "
                         f"time biases, the kernel holds at most {MAX_POS} / {MAX_BUCKETS}")
    if q.stride(0) % 8 or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("hstu_attention: q, k and v rows must start 16-byte aligned "
                         f"(row stride {q.stride(0)} elements)")
    y = torch.empty((N, H, v.shape[2]), dtype=torch.float32, device=q.device)
    S = n_hist.shape[0]
    if N == 0 or S == 0:
        return y
    T = offsets[1:] - offsets[:-1]
    tile_off = torch.zeros(S + 1, dtype=torch.int32, device=q.device)
    tile_off[1:] = torch.cumsum((T + QUERY_ROWS - 1) // QUERY_ROWS, 0, dtype=torch.int32)
    # an upper bound of the query tiles, known without a sync: the blocks
    # past the last tile return at once
    grid = (N + S * (QUERY_ROWS - 1)) // QUERY_ROWS
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.otto_hstu_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(), offsets.data_ptr(),
            n_hist.data_ptr(), tile_off.data_ptr(), ts.data_ptr(), w_pos.data_ptr(),
            w_time.data_ptr(), thr.data_ptr(), q.stride(0), S, H, w_pos.shape[0],
            w_time.shape[0], grid, float(n_scale), stream)
    _build.check(err, "hstu_attention")
    LAUNCHES.add()   # the pipelined runners launch from two threads
    return y
