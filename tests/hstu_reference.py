"""The HSTU ranker's plain reference (otto_tpu_torch/models/hstu.py), for
the tests: plain torch in float32, one session at a time, the full
[T, T] score matrix of every head with the target-aware mask applied.
No kernel of the port and no jax. benchmark/reference/hstu.py is the
benchmark's copy.

`precision` rounds every product's operands: "full" to bfloat16 (the
ranker's precision), "low" to float8 e4m3 (the control). `fault` plants
one wrong step: "no_bias" drops both relative biases, "softmax" puts a
softmax over the open keys in place of SiLU / n_scale.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32
F64 = torch.float64
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0
BUCKET_LOG = 0.301


def no_tf32() -> None:
    """float32 products in float32 on a card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A product's operand as the precision rounds it, back in float32."""
    if precision == "low":
        return x.clamp(-FP8_MAX, FP8_MAX).to(FP8).to(F32)
    return x.to(torch.bfloat16).to(F32)


def mm(a, b, precision):
    return torch.matmul(operand(a, precision), operand(b, precision))


def bucket(dt: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """min(floor(ln(max(|dt|, 1)) / 0.301), n_buckets), in float64."""
    x = dt.abs().clamp(min=1).to(F64)
    return torch.floor(torch.log(x) / BUCKET_LOG).clamp(max=n_buckets).long()


def log_squash(x: torch.Tensor) -> torch.Tensor:
    x = x.to(F64)
    return (torch.sign(x) * torch.log1p(torch.abs(x))).to(F32)


def session_scores(p: dict, cfg, aid, ts, type_, cand, feats, precision: str = "full",
                   fault: str = "") -> torch.Tensor:
    """One session: aid / ts / type_ [n] its events in time order, cand [C]
    its valid candidates, feats [C, F] their features; p the ranker's
    float32 parameters (models/hstu.py::param_shapes' names) and cfg its
    HSTUConfig. -> scores [3, C] float32."""
    dev = p["item_emb"].device
    d, H, dqk, dv = cfg.d_model, cfg.n_heads, cfg.d_qk, cfg.d_v
    L = min(len(aid), cfg.max_seq_len)
    aid, ts, type_ = (torch.as_tensor(np.asarray(a)[len(a) - L:], device=dev).long()
                      for a in (aid, ts, type_))
    cand = torch.as_tensor(np.asarray(cand), device=dev).long()
    C = cand.shape[0]
    T = L + C
    x_h = p["item_emb"][aid] + p["type_emb"][type_]
    f = (log_squash(torch.as_tensor(feats, device=dev)) - p["norm_mean"]) / p["norm_std"]
    x_c = p["item_emb"][cand] + mm(f, p["feat_proj"], precision)
    x = torch.cat([x_h, x_c])
    last = ts[-1] if L else torch.zeros((), dtype=torch.long, device=dev)
    pos = torch.cat([torch.arange(L, device=dev), torch.full((C,), L, device=dev)])
    tts = torch.cat([ts, last.expand(C)])
    mask = torch.zeros((T, T), dtype=torch.bool, device=dev)
    mask[:L, :L] = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))
    mask[L:, :L] = True
    mask[L:, L:] = torch.eye(C, dtype=torch.bool, device=dev)
    dpos = (pos[:, None] - pos[None, :]).clamp(0, cfg.max_seq_len)
    bkt = bucket(tts[:, None] - tts[None, :], cfg.n_time_buckets)
    for i in range(cfg.n_blocks):
        n = F.layer_norm(x, (d,), eps=cfg.eps)
        h = F.silu(mm(n, p[f"w1_{i}"], precision) + p[f"b1_{i}"])
        u, v, q, k = torch.split(h, [H * dv, H * dv, H * dqk, H * dqk], dim=1)
        q = q.reshape(T, H, dqk).transpose(0, 1)
        k = k.reshape(T, H, dqk).transpose(0, 1)
        v = v.reshape(T, H, dv).transpose(0, 1)
        s = mm(q, k.transpose(1, 2), precision)                       # [H, T, T]
        if fault != "no_bias":
            s = s + p[f"w_pos_{i}"][dpos]
            s = s + p[f"w_time_{i}"][bkt]
        if fault == "softmax":
            a = torch.softmax(s.masked_fill(~mask, -torch.inf), dim=-1)
        else:
            a = torch.where(mask, F.silu(s) / cfg.n_scale, 0.0)
        y = mm(a, v, precision).transpose(0, 1).reshape(T, H * dv)
        y = F.layer_norm(y, (H * dv,), eps=cfg.eps) * u
        x = x + (mm(y, p[f"w2_{i}"], precision) + p[f"b2_{i}"])
    xc = F.layer_norm(x[L:], (d,), eps=cfg.eps)
    return (mm(xc, p["head_w"], precision) + p["head_b"]).t()

