"""Heuristic co-visitation recommender: the cheap end-to-end check of the
co-visitation tables.

Counterpart of otto_tpu/engine/baseline.py: each session's last unique
aids (the self source, recency- and type-weighted) united with their
co-visitation neighbours from the dense top-N tables, scored by
normalised counts, deduplicated per session with summed scores, top-k.
The per-session groupbys are the row-wise ones of ops/segment.py, so they
run K1 and K2 on the card.

XLA turns otto_tpu's divisions by the constants 100 and 1e4 into
multiplications by their float32 reciprocals; the port multiplies, so
the scores round alike.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from otto_tpu_torch.data.batching import iter_microbatches, pack_sessions
from otto_tpu_torch.data.schema import Events
from otto_tpu_torch.engine.covis import CoVisTables
from otto_tpu_torch.ops import segment as seg

SENT = seg.SENTINEL
F32 = torch.float32
I32 = torch.int32


def recommend_batch(
    aid: torch.Tensor,          # [S, L] int32, -1 padding
    ts: torch.Tensor,           # [S, L] int32
    type_: torch.Tensor,        # [S, L] int32
    tables: Sequence[Tuple[torch.Tensor, torch.Tensor]],  # (nbr [A, N], cnt [A, N])
    keep_aids: int,
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (cand [S, top_k] int32 -1 pad, score [S, top_k] float32). Ties in
    the final top-k go to the lower unique aid, as `lax.top_k` breaks
    them."""
    S, L = aid.shape
    valid = aid >= 0

    # last `keep_aids` unique aids per session, with recency/type weight
    type_w = torch.tensor([1.0, 3.0, 6.0], dtype=F32, device=aid.device)[
        type_.clamp(0, 2).long()]
    uk, (u_ts, u_w), _ = seg.rowwise_segment_reduce(
        torch.where(valid, aid, SENT), (ts, (type_w * 100).to(I32)), ("max", "max"))
    u_valid = uk != SENT
    order = seg.rowwise_rank_desc(torch.where(u_valid, u_ts, 0), u_valid)  # 1 = newest
    keep = u_valid & (order <= keep_aids)
    (sk,), (src_aid, src_w) = seg.rowwise_sort(
        (torch.where(keep, order, SENT),), (uk, u_w))
    src_aid = src_aid[:, :keep_aids]                       # [S, A]
    src_w = src_w[:, :keep_aids].to(F32) * 0.01
    src_rank = sk[:, :keep_aids]                           # recency order, SENT pad
    src_ok = src_rank != SENT
    w_src = torch.where(src_ok, src_w / src_rank.to(F32), 0.0)

    # the self source, then each table's neighbours of the kept aids
    cands: List[torch.Tensor] = [torch.where(src_ok, src_aid, -1)]
    scores: List[torch.Tensor] = [torch.where(src_ok, 10.0 * w_src, 0.0)]
    for nbr_t, cnt_t in tables:
        g = src_aid.clamp(0, nbr_t.shape[0] - 1).long()
        nbr = nbr_t[g]                                     # [S, A, N]
        cnt = cnt_t[g].to(F32)
        ok = src_ok[:, :, None] & (nbr >= 0)
        cmax = cnt.amax(dim=2, keepdim=True).clamp(min=1.0)
        sc = torch.where(ok, (cnt / cmax) * w_src[:, :, None], 0.0)
        cands.append(torch.where(ok, nbr, -1).reshape(S, -1))
        scores.append(sc.reshape(S, -1))
    cand = torch.cat(cands, dim=1)
    score = torch.cat(scores, dim=1)

    # dedup per session, summing scores
    uk, (uscore,), _ = seg.rowwise_segment_reduce(
        torch.where(cand >= 0, cand, SENT), ((score * 1e4).to(I32),), ("sum",))
    vals, idx = torch.sort(torch.where(uk != SENT, uscore, -1), dim=1,
                           descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    out_cand = torch.where(vals > -1, torch.gather(uk, 1, idx), -1)
    return out_cand, vals.to(F32) * 1e-4


def recommend(
    test: Events,
    tables: Dict[str, CoVisTables],
    keep_aids: int = 32,
    top_k: int = 20,
    source_names: Tuple[str, ...] = (
        "click_to_click",
        "click_to_cart_or_buy",
        "cart_to_cart",
        "cart_to_buy",
        "buy_to_buy",
    ),
    batch_sessions: int = 2048,
) -> Tuple[np.ndarray, np.ndarray]:
    """Every test session on the tables' device, in batches -> (sessions
    [N] sorted, top-k aids [N, top_k])."""
    dev_tables = tuple((tables[n].neighbor, tables[n].count)
                       for n in source_names if n in tables)
    dev = dev_tables[0][0].device
    out_s, out_a = [], []
    for p in pack_sessions(test):
        for mb in iter_microbatches(p, min(batch_sessions, max(1, p.n_sessions))):
            cand, _ = recommend_batch(
                *(torch.from_numpy(x).to(dev) for x in (mb.aid, mb.ts, mb.type)),
                dev_tables, keep_aids, top_k)
            keep = mb.session >= 0
            out_s.append(mb.session[keep])
            out_a.append(cand.cpu().numpy()[keep])
    sessions = np.concatenate(out_s)
    aids = np.concatenate(out_a)
    order = np.argsort(sessions)
    return sessions[order], aids[order]
