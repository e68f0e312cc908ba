"""HSTU as a multi-task ranker (`ranker_backend="hstu"`).

The Hierarchical Sequential Transduction Unit of "Actions Speak Louder
than Words" (Zhai et al., ICML 2024, arXiv:2402.17152), used as a ranker:
a session's candidates join its event history as targets, each attends
the whole history and itself only (M-FALCON), and one pass scores every
candidate of a batch for the three target types.

Tokens. History event i (aid, type, ts): `E[aid] + T[type]`, at position
i. Candidate c: `E[cand] + P f`, where f are its retrieval features,
log-squashed and normalised as the MLP tower does, at position L (the
history's length) and the session's last timestamp. The history keeps
its last `max_seq_len` events. E [A, d] is the float32 item table, read
through kernel K4 (ops/kernels/dma_gather.py).

A block (n_blocks of them), on X [tokens, d] (the float32 residual):

    N       = LayerNorm(X)
    U,V,Q,K = split(SiLU(N W1 + b1))
    A_h     = SiLU(Q_h K_h^T + w_pos[dpos] + w_time[bucket(dt)]) * mask / n_scale
    X       = X + (LayerNorm(concat_h A_h V_h) * U) W2 + b2

with the target-aware mask and the biases of kernel K6
(ops/kernels/hstu_attention.py). The scores: LayerNorm(X[c]) . w_t + b_t
for t = clicks, carts, orders. The LayerNorms have no affine part.
Every product takes bfloat16 operands and sums in float32 (`mm`, K6);
LayerNorm, SiLU, the biases and the residual are float32.

A batch is packed into jagged tokens (`pack`): every session's history,
then its valid candidates, with per-session offsets, so that no padded
history lane or empty candidate slot enters a product. The port serves a
saved ranker (`save` / `load`, an `.npz`); it does not train one.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from otto_tpu_torch.config import TYPES, HSTUConfig
from otto_tpu_torch.models.ranker import _log_squash
from otto_tpu_torch.ops.kernels.dma_gather import gather_rows_hbm
from otto_tpu_torch.ops.kernels.hstu_attention import hstu_attention, time_bucket_thresholds
from otto_tpu_torch.utils import timing

F32 = torch.float32
BF16 = torch.bfloat16

# valid tokens encoded, and query-key pairs the mask leaves open, since the
# last reset
TOKENS = timing.counter("otto::rank.hstu_tokens")
PAIRS = timing.counter("otto::rank.hstu_pairs")


def mm(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None
       ) -> torch.Tensor:
    """a @ b (+ bias) with both operands rounded to bfloat16, summed in
    float32 and returned in float32; the float32 bias is added to the
    float32 sum. On the card one cuBLAS call with a float32 output and the
    bias in its epilogue; on the CPU the bfloat16 values' products are
    exact in float32."""
    a, b = a.to(BF16), b.to(BF16)
    if a.device.type == "cuda":
        if bias is None:
            return torch.mm(a, b, out_dtype=F32)
        return torch.addmm(bias, a, b, out_dtype=F32)
    out = torch.mm(a.float(), b.float())
    return out if bias is None else out + bias


def param_shapes(cfg: HSTUConfig, n_aids: int, n_features: int) -> Dict[str, tuple]:
    """Every parameter's shape, by its name in `save`'s file."""
    d, H = cfg.d_model, cfg.n_heads
    width = 2 * H * cfg.d_v + 2 * H * cfg.d_qk
    out = {"item_emb": (n_aids, d), "type_emb": (3, d), "feat_proj": (n_features, d),
           "norm_mean": (n_features,), "norm_std": (n_features,),
           "head_w": (d, len(TYPES)), "head_b": (len(TYPES),)}
    for i in range(cfg.n_blocks):
        out.update({f"w1_{i}": (d, width), f"b1_{i}": (width,),
                    f"w_pos_{i}": (cfg.max_seq_len + 1,),
                    f"w_time_{i}": (cfg.n_time_buckets + 1,),
                    f"w2_{i}": (H * cfg.d_v, d), f"b2_{i}": (d,)})
    return out


class Packed(NamedTuple):
    """A batch in jagged tokens: N = n_hist.sum() + the valid candidates.
    Session s holds tokens offsets[s] .. offsets[s + 1] - 1, its history
    first. h_* index the history tokens (their destination token, session
    and history lane), c_* the candidate tokens (destination, session,
    candidate slot)."""

    offsets: torch.Tensor    # [S + 1] int32
    n_hist: torch.Tensor     # [S] int32
    ts: torch.Tensor         # [N] int32 token timestamps
    ids: torch.Tensor        # [N] int32 item ids
    h_dst: torch.Tensor
    h_type: torch.Tensor
    c_dst: torch.Tensor
    c_sess: torch.Tensor
    c_slot: torch.Tensor
    n_tokens: int
    n_pairs: int


def pack(aid: torch.Tensor, ts: torch.Tensor, type_: torch.Tensor, cand: torch.Tensor,
         max_seq_len: int) -> Packed:
    """aid / ts / type_ [S, Lb] int32 left-aligned histories (aid -1 past a
    session's events), cand [S, C] int32 (-1: an empty slot) -> Packed.
    Each history keeps its last max_seq_len events; the candidates keep
    their slot order. One sync, for the token count."""
    dev = cand.device
    S = cand.shape[0]
    i64 = torch.int64
    lens = (aid >= 0).sum(1)
    L = lens.clamp(max=max_seq_len)
    cvalid = cand >= 0
    C = cvalid.sum(1)
    offsets = torch.zeros(S + 1, dtype=i64, device=dev)
    offsets[1:] = torch.cumsum(L + C, 0)
    pairs = (L * (L + 1) // 2 + C * (L + 1)).sum()
    nh, nc, n_pairs = (int(x) for x in torch.stack([L.sum(), C.sum(), pairs]).tolist())
    sess = torch.arange(S, device=dev)
    h_sess = torch.repeat_interleave(sess, L, output_size=nh)
    h_i = torch.arange(nh, device=dev) - (torch.cumsum(L, 0) - L)[h_sess]
    h_lane = (lens - L)[h_sess] + h_i
    h_dst = offsets[h_sess] + h_i
    # the valid slots of each row first, in slot order
    order = torch.sort((~cvalid).to(torch.uint8), dim=1, stable=True).indices
    c_sess = torch.repeat_interleave(sess, C, output_size=nc)
    c_k = torch.arange(nc, device=dev) - (torch.cumsum(C, 0) - C)[c_sess]
    c_slot = order[c_sess, c_k]
    c_dst = offsets[c_sess] + L[c_sess] + c_k
    N = nh + nc
    if N >= 2**31:
        raise ValueError(f"hstu: {N} tokens in one batch, above 2^31 - 1")
    ids = torch.empty(N, dtype=torch.int32, device=dev)
    ids[h_dst] = aid[h_sess, h_lane]
    ids[c_dst] = cand[c_sess, c_slot]
    tok_ts = torch.empty(N, dtype=torch.int32, device=dev)
    tok_ts[h_dst] = ts[h_sess, h_lane]
    last = ts[sess, (lens - 1).clamp(min=0)]
    tok_ts[c_dst] = last[c_sess]
    return Packed(offsets.to(torch.int32), L.to(torch.int32), tok_ts, ids, h_dst,
                  type_[h_sess, h_lane].long(), c_dst, c_sess, c_slot, N, n_pairs)


class _OnDevice:
    """The ranker's parameters on one device: float32, with the product
    operands also kept in bfloat16."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: HSTUConfig, device):
        p = {k: torch.as_tensor(v).to(device=device, dtype=F32) for k, v in params.items()}
        self.item_emb = p["item_emb"].contiguous()
        self.type_emb = p["type_emb"]
        self.feat_proj = p["feat_proj"].to(BF16)
        self.norm_mean, self.norm_std = p["norm_mean"], p["norm_std"]
        self.head_w, self.head_b = p["head_w"].to(BF16), p["head_b"]
        self.blocks = [{"w1": p[f"w1_{i}"].to(BF16), "b1": p[f"b1_{i}"],
                        "w_pos": p[f"w_pos_{i}"].contiguous(),
                        "w_time": p[f"w_time_{i}"].contiguous(),
                        "w2": p[f"w2_{i}"].to(BF16), "b2": p[f"b2_{i}"]}
                       for i in range(cfg.n_blocks)]
        self.thr = time_bucket_thresholds(cfg.n_time_buckets, device)


@dataclasses.dataclass
class HSTURanker:
    """One HSTU ranker for every target type. `params` holds float32
    tensors (or arrays) named as `param_shapes` says; scoring copies them
    to the batch's device on first use (nothing is copied where they
    already live)."""

    cfg: HSTUConfig
    params: Dict[str, object]
    feature_names: Tuple[str, ...]
    tasks: Tuple[str, ...] = TYPES
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        n_aids = int(self.params["item_emb"].shape[0])
        want = param_shapes(self.cfg, n_aids, len(self.feature_names))
        got = {k: tuple(v.shape) for k, v in self.params.items()}
        if got != want:
            wrong = sorted(set(got) ^ set(want)) or sorted(
                k for k in want if got[k] != want[k])
            raise ValueError(f"hstu: parameters do not fit {self.cfg}: {wrong[:6]}")

    def on(self, device) -> _OnDevice:
        key = str(torch.device(device))
        if key not in self._on_device:
            self._on_device[key] = _OnDevice(self.params, self.cfg, torch.device(device))
        return self._on_device[key]

    def predict_scores_multi(self, b) -> torch.Tensor:
        """A RetrievedBatch -> scores [n_tasks, S, C] float32 on its device
        (-inf at empty candidate slots)."""
        aid, ts, type_ = b.history_device()
        return self.encode(aid, ts, type_, b.cand_device(), b.feats)

    def encode(self, aid, ts, type_, cand, feats) -> torch.Tensor:
        """aid / ts / type_ [S, Lb] int32 left-aligned histories, cand [S, C]
        int32, feats [S, C, F] float32 -> scores [n_tasks, S, C] float32."""
        cfg = self.cfg
        d, H = cfg.d_model, cfg.n_heads
        hv, hq = H * cfg.d_v, H * cfg.d_qk
        w = self.on(cand.device)
        S, C = cand.shape
        with torch.no_grad(), timing.span("otto::rank.hstu"):
            with timing.span("otto::rank.hstu.pack"):
                pk = pack(aid, ts, type_, cand, cfg.max_seq_len)
                N = pk.n_tokens
                x = gather_rows_hbm(w.item_emb, pk.ids)
                x[pk.h_dst] += w.type_emb[pk.h_type]
                f = (_log_squash(feats[pk.c_sess, pk.c_slot]) - w.norm_mean) / w.norm_std
                x[pk.c_dst] += mm(f, w.feat_proj)
            TOKENS.add(N)
            PAIRS.add(pk.n_pairs)
            for i, blk in enumerate(w.blocks):
                with timing.span("otto::rank.hstu.block", index=i):
                    h = mm(F.layer_norm(x, (d,), eps=cfg.eps), blk["w1"], blk["b1"])
                    F.silu(h, inplace=True)
                    hb = h[:, hv:].to(BF16)
                    v = hb[:, :hv].view(N, H, cfg.d_v)
                    q = hb[:, hv:hv + hq].view(N, H, cfg.d_qk)
                    k = hb[:, hv + hq:].view(N, H, cfg.d_qk)
                    y = hstu_attention(q, k, v, pk.offsets, pk.n_hist, pk.ts, blk["w_pos"],
                                       blk["w_time"], w.thr, cfg.n_scale)
                    y = F.layer_norm(y.view(N, hv), (hv,), eps=cfg.eps) * h[:, :hv]
                    del h, hb, q, k, v
                    x += mm(y, blk["w2"], blk["b2"])
                    del y
            xc = F.layer_norm(x[pk.c_dst], (d,), eps=cfg.eps)
            sc = mm(xc, w.head_w, w.head_b)
            scores = torch.full((len(self.tasks), S, C), -torch.inf, dtype=F32,
                                device=cand.device)
            scores[:, pk.c_sess, pk.c_slot] = sc.t()
        return scores

    def save(self, path: str) -> None:
        flat = {k: np.asarray(torch.as_tensor(v).detach().cpu(), np.float32)
                for k, v in self.params.items()}
        flat["feature_names"] = np.array(self.feature_names)
        flat["hstu_config"] = np.array(json.dumps(dataclasses.asdict(self.cfg)))
        np.savez(path, **flat)

    @staticmethod
    def load(path: str) -> "HSTURanker":
        """A ranker `save` wrote (parameters on the CPU)."""
        z = np.load(path, allow_pickle=False)
        if "hstu_config" not in z.files:
            raise ValueError(f"{path} holds no HSTU ranker (no hstu_config)")
        cfg = HSTUConfig(**json.loads(str(z["hstu_config"])))
        names = tuple(z["feature_names"].tolist())
        params = {k: torch.from_numpy(z[k]) for k in z.files
                  if k not in ("feature_names", "hstu_config")}
        return HSTURanker(cfg, params, names)

