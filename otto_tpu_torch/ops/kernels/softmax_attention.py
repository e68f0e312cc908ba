"""K6's softmax form: the MLA + MoE ranker's attention on the jagged token
layout (models/mla_moe.py).

The layout is K6's (ops/kernels/hstu_attention.py): q / k [N, H, Dqk] and
v [N, H, Dv] bfloat16, `offsets` [S + 1] and `n_hist` [S] int32, each
session's history tokens and then its candidates. For every session, head
and query token i:

    y[i] = sum_j bf16(softmax_j(scale * q_i . k_j)) * v_j

over the keys j the target-aware mask allows: a history token attends the
history tokens j <= i, a candidate every history token and itself. The
products take bfloat16 operands and sum in float32; the scores and the
softmax are float32; y is float32 [N, H, Dv].

The CUDA kernel is `softmax_attention_kernel` in
`otto_tpu_torch/csrc/hstu_attention.cu` (one launch for every session,
head and query tile; an online softmax, so no score tensor in memory);
`softmax_attention_ref` is its plain PyTorch twin, which a CPU tensor
runs. The kernel rounds the unnormalised weights to bfloat16 where the
twin rounds the normalised ones, and sums in another order, so the two
agree to bfloat16 rounding of the weights, not bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from otto_tpu_torch.ops.kernels import _build
from otto_tpu_torch.ops.kernels.hstu_attention import check_layout
from otto_tpu_torch.utils import timing

# kernel launches since the last reset (see gather.LAUNCHES)
LAUNCHES = timing.counter("otto::kernels.softmax_attention")

# the kernel's widths and query rows a block (hstu_attention.cu SQK, SV, SBM)
QK_DIM = 192
V_DIM = 128
QUERY_ROWS = 64
# elements of the twin's gathered keys per chunk of query rows (16 times as
# many on a card, where it checks the kernel at the serving shapes)
_TWIN_BUDGET = 1 << 24
# check_layout's position cap: this form has no position table
_NO_POS_CAP = 2**31 - 1


def _check(q, k, v, offsets, n_hist):
    tensors = {"q": q, "k": k, "v": v, "offsets": offsets, "n_hist": n_hist}
    want = {"q": torch.bfloat16, "k": torch.bfloat16, "v": torch.bfloat16,
            "offsets": torch.int32, "n_hist": torch.int32}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"softmax_attention: {name} is not a tensor")
        if t.dtype != want[name]:
            raise TypeError(f"softmax_attention: {name} is {t.dtype}, want {want[name]}")
    if q.dim() != 3 or k.shape != q.shape or v.dim() != 3 or v.shape[:2] != q.shape[:2]:
        raise ValueError(
            f"softmax_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            "are not [N, H, Dqk], [N, H, Dqk], [N, H, Dv]")
    if offsets.dim() != 1 or n_hist.dim() != 1 or offsets.shape[0] != n_hist.shape[0] + 1:
        raise ValueError(f"softmax_attention: offsets {tuple(offsets.shape)}, n_hist "
                         f"{tuple(n_hist.shape)} are not [S + 1], [S]")
    if not (offsets.is_contiguous() and n_hist.is_contiguous()):
        raise ValueError("softmax_attention: offsets and n_hist must be contiguous")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"softmax_attention: tensors on more than one device: "
                         f"{sorted(map(str, devices))}")


def softmax_attention_ref(q, k, v, offsets, n_hist, scale: float) -> torch.Tensor:
    """Plain twin: each chunk of query rows gathers its session's history
    keys, padded to the batch's longest history and masked, with the
    row's own key beside them (open for candidates only); the softmax is
    taken over both and rounded to bfloat16 before the product with v."""
    _check(q, k, v, offsets, n_hist)
    N, H, Dqk = q.shape
    Dv = v.shape[2]
    dev = q.device
    check_layout(offsets, n_hist, N, _NO_POS_CAP)
    y = torch.zeros((N, H, Dv), dtype=torch.float32, device=dev)
    S = n_hist.shape[0]
    if N == 0 or S == 0:
        return y
    off = offsets.long()
    L = n_hist.long()
    sess = torch.repeat_interleave(torch.arange(S, device=dev), off[1:] - off[:-1])
    r = torch.arange(N, device=dev) - off[sess]
    qf, kf, vf = q.float(), k.float(), v.float()
    Lmax = int(L.max())
    j = torch.arange(Lmax, device=dev)
    budget = _TWIN_BUDGET * (16 if dev.type == "cuda" else 1)
    step = max(1, budget // (max(Lmax, 1) * H * max(Dqk, Dv)))
    for c0 in range(0, N, step):
        rows = torch.arange(c0, min(N, c0 + step), device=dev)
        s_, r_ = sess[rows], r[rows]
        L_ = L[s_]
        kvalid = j[None, :] < L_[:, None]
        key = torch.where(kvalid, off[s_][:, None] + j[None, :], 0)
        is_h = r_ < L_
        allowed = kvalid & (~is_h[:, None] | (j[None, :] <= r_[:, None]))
        sc = torch.einsum("nhd,nlhd->nhl", qf[rows], kf[key]) * scale
        sc = sc.masked_fill(~allowed[:, None, :], -torch.inf)
        own = ((qf[rows] * kf[rows]).sum(-1) * scale).masked_fill(is_h[:, None], -torch.inf)
        a = torch.softmax(torch.cat([sc, own[..., None]], -1), -1)
        a = a.to(torch.bfloat16).float()
        y[rows] = (torch.einsum("nhl,nlhd->nhd", a[..., :Lmax], vf[key])
                   + a[..., Lmax:] * vf[rows])
    return y


def softmax_attention(q, k, v, offsets, n_hist, scale: float,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y [N, H, Dv] float32, written into `out` where given (contiguous
    [N, H, Dv] float32). A CPU tensor runs the twin; a CUDA tensor one
    launch of the kernel on the current stream (Dqk = QK_DIM, Dv = V_DIM,
    q, k and v contiguous). The kernel trusts the layout's contents:
    check_layout validates them (a sync)."""
    _check(q, k, v, offsets, n_hist)
    N, H, _ = q.shape
    if out is not None and (out.dtype != torch.float32 or not out.is_contiguous()
                            or tuple(out.shape) != (N, H, v.shape[2])
                            or out.device != q.device):
        raise ValueError(f"softmax_attention: out must be a contiguous [{N}, {H}, "
                         f"{v.shape[2]}] float32 tensor on {q.device}")
    if q.device.type == "cpu":
        y = softmax_attention_ref(q, k, v, offsets, n_hist, scale)
        return y if out is None else out.copy_(y)
    if q.device.type != "cuda":
        raise ValueError(f"softmax_attention: no kernel for {q.device}")
    D = q.shape[2]
    if D != QK_DIM or v.shape[2] != V_DIM:
        raise ValueError(f"softmax_attention: the kernel takes q, k {QK_DIM} and v {V_DIM} "
                         f"wide, not {D} and {v.shape[2]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("softmax_attention: the kernel takes contiguous q, k and v")
    y = torch.empty((N, H, V_DIM), dtype=torch.float32, device=q.device) if out is None else out
    if any(t.data_ptr() % 16 for t in (q, k, v, y)):
        raise ValueError("softmax_attention: q, k, v and out must start 16-byte aligned")
    S = n_hist.shape[0]
    if N == 0 or S == 0:
        return y
    T = offsets[1:] - offsets[:-1]
    tile_off = torch.zeros(S + 1, dtype=torch.int32, device=q.device)
    tile_off[1:] = torch.cumsum((T + QUERY_ROWS - 1) // QUERY_ROWS, 0, dtype=torch.int32)
    # an upper bound of the query tiles, known without a sync
    grid = (N + S * (QUERY_ROWS - 1)) // QUERY_ROWS
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.otto_softmax_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(), offsets.data_ptr(),
            n_hist.data_ptr(), tile_off.data_ptr(), S, H, grid, float(scale), stream)
    _build.check(err, "softmax_attention")
    LAUNCHES.add()   # the pipelined runners launch from two threads
    return y
