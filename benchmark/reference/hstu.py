"""The plain reference of the HSTU ranker (otto_tpu_torch/models/hstu.py),
the benchmark's copy of tests/hstu_reference.py: plain torch in float32,
one session at a time, the full [T, T] score matrix of every head with
the target-aware mask applied, TF32 off. No kernel of the port and no
jax. `reference_scores` runs it over a sample of served sessions after the
frozen retrieval (benchmark/reference/retrieval.py), one microbatch of
the program's length buckets at a time, as reference/check.py does for
the feature-only rankers.

`precision` rounds every product's operands: "full" to bfloat16 (the
configuration's precision), "low" to float8 e4m3 (the control of
benchmark/PERF.md). `fault` plants one wrong step for the tests:
"no_bias" drops both relative biases, "softmax" puts a softmax over the
open keys in place of SiLU / n_scale. `cfg` is the configuration's
"hstu" dict (an object with its keys as attributes).
"""
from __future__ import annotations

import types
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.batching import iter_microbatches, pack_sessions
from benchmark.reference.check import RefSession, trim_params
from benchmark.reference.retrieval import retrieve_batch

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
    "hstu" settings. -> scores [3, C] float32."""
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


def reference_scores(cols, cluster_of: Dict[int, int], emb_of: Dict[int, np.ndarray], ctx,
                     retrieval: dict, params: dict, hstu: dict, batch: int,
                     precisions: Sequence[str] = ("full",)) -> Dict[int, RefSession]:
    """cols: (session, aid, ts, type) of the sampled sessions, sorted by
    (session, ts); cluster_of / emb_of: each sampled session's cluster and
    embedding; params: the ranker's float32 parameters on the device;
    hstu: the configuration's "hstu" dict. -> {session: RefSession} with
    scores [3, n] per precision."""
    no_tf32()
    cfg = types.SimpleNamespace(**hstu)
    dev = ctx.aid_emb.device
    trim = trim_params(retrieval, dev)
    out: Dict[int, RefSession] = {}

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    for p in pack_sessions(*cols, bucket_lens=retrieval["session_len_buckets"]):
        for mb in iter_microbatches(p, min(batch, p.n_sessions)):
            real = mb.session >= 0
            cl = np.array([cluster_of.get(int(s), 0) for s in mb.session], np.int32)
            none = np.zeros(ctx.aid_emb.shape[1], np.float32)
            em = np.stack([emb_of.get(int(s), none) for s in mb.session]).astype(np.float32)
            cand, feats, _ = retrieve_batch(
                (put(mb.aid), put(mb.ts), put(mb.type)), ctx, put(cl), put(em), trim,
                retrieval["max_session_aids"], retrieval["max_candidates"])
            cand_h = cand.cpu().numpy()
            for i in np.nonzero(real)[0]:
                n = int(mb.length[i])
                ok = cand_h[i] >= 0
                sc = {prec: session_scores(params, cfg, mb.aid[i, :n], mb.ts[i, :n],
                                           mb.type[i, :n], cand_h[i][ok], feats[i][ok],
                                           prec).cpu().numpy()
                      for prec in precisions}
                out[int(mb.session[i])] = RefSession(cand_h[i][ok], sc)
    return out
