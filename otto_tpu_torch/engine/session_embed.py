"""Session embeddings and the item kNN tables (C9, C10).

Counterpart of otto_tpu/engine/session_embed.py.

A session's embedding is the type- and recency-weighted mean of its aids'
item embeddings:
  weight = weight_time * weight_type
  weight_time = clip(1 - (max_ts - ts) / 3 days, min=0.10)
  weight_type = {click: .1, cart: .3, order: .6}
Aids without an embedding contribute zeros, but their weight still enters
the denominator. Each result is rounded to float16 and back, as otto_tpu
rounds it on every path: k-means, and the cluster popularity after it,
see the rounded values.

The kNN tables are dense [n_aids, k]: for the `knn_first_n_aids` most
frequent words, their k nearest words (squared L2, nearest first, the word
itself included) as aids; -1 rows for every other aid.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from otto_tpu_torch.data.batching import PaddedSessions, iter_microbatches
from otto_tpu_torch.models.word2vec import Word2Vec
from otto_tpu_torch.ops.kernels.dma_gather import gather_rows_hbm
from otto_tpu_torch.ops.knn import knn_search

DAY = 24 * 60 * 60
TYPE_WEIGHTS = (0.1, 0.3, 0.6)


class KnnTables(NamedTuple):
    """Dense per-aid w2vec neighbour tables: neighbor [A, k] int32 (-1 pad)
    and dist [A, k] float32 squared L2."""

    neighbor: torch.Tensor
    dist: torch.Tensor


def session_embedding_batch(
    aid: torch.Tensor,        # [S, L] int32, -1 pad
    ts: torch.Tensor,         # [S, L] int32
    type_: torch.Tensor,      # [S, L] int32
    emb_table: torch.Tensor,  # [A, D] float32 (0 for aids without one)
) -> torch.Tensor:
    """-> [S, D] float32 weighted means (not rounded)."""
    S, L = aid.shape
    valid = aid >= 0
    max_ts = torch.where(valid, ts, -(2**31 - 1)).amax(dim=1, keepdim=True)
    w_time = (1.0 - (max_ts - ts).to(torch.float32) / (3 * DAY)).clamp(min=0.10)
    type_w = torch.tensor(TYPE_WEIGHTS, dtype=torch.float32, device=aid.device)
    w_type = type_w[type_.clamp(0, 2).long()]
    w = torch.where(valid, w_time * w_type, 0.0)                  # [S, L]
    # K4: the [S * L] row gather (ids clamped into the table)
    vecs = gather_rows_hbm(emb_table, aid.reshape(-1)).reshape(S, L, -1)
    num = torch.einsum("sl,sld->sd", w, vecs)
    den = w.sum(dim=1, keepdim=True).clamp(min=1e-9)
    return num / den


def compute_session_embeddings(
    padded_batches: Sequence[PaddedSessions], emb_table: torch.Tensor,
    lane_budget: int = 1 << 19,
) -> Tuple[np.ndarray, torch.Tensor]:
    """Bucketed sessions -> (session ids [N] sorted, embeddings [N, D]
    float32 on the table's device, float16-rounded).

    Each bucket runs in microbatches of about `lane_budget` [S, L] lanes
    (a power of two of rows, at least 8): the gathered [S, L, D] grid is
    ~400 B a lane at D = 100, so a whole bucket at once would need tens of
    GB at OTTO scale."""
    dev = emb_table.device
    sids, embs = [], []
    for p in padded_batches:
        L = p.aid.shape[1]
        rows = max(8, 1 << (max(1, lane_budget // L).bit_length() - 1))
        for mb in iter_microbatches(p, min(rows, 1 << 20)):
            # one upload of the stacked (aid, ts, type) microbatch
            stk = torch.from_numpy(np.stack([mb.aid, mb.ts, mb.type])).to(dev)
            e = session_embedding_batch(stk[0], stk[1], stk[2], emb_table)
            keep = np.flatnonzero(mb.session >= 0)
            sids.append(mb.session[keep])
            e = e.index_select(0, torch.from_numpy(keep).to(dev))
            embs.append(e.to(torch.float16).to(torch.float32))
    session = np.concatenate(sids)
    order = np.argsort(session)
    emb = torch.cat(embs).index_select(0, torch.from_numpy(order).to(dev))
    return session[order], emb


def build_knn_tables(
    model: Word2Vec, n_aids: int, device, k: Optional[int] = None,
    first_n: Optional[int] = None,
) -> KnnTables:
    """Neighbours of the `first_n` most frequent words (default: the
    model's knn_first_n_aids) among all of the model's words, on
    `device`."""
    cfg = model.cfg
    k = k or cfg.knn_k
    first_n = min(first_n or cfg.knn_first_n_aids, model.vocab.size)
    dev = torch.device(device)
    emb = torch.from_numpy(np.ascontiguousarray(model.emb, np.float32)).to(dev)
    scores, idx = knn_search(emb[:first_n], emb, k, metric="l2")
    aid_of_word = torch.from_numpy(
        np.ascontiguousarray(model.vocab.aid_of_word, np.int32)).to(dev)
    nbr_aid = torch.where(idx >= 0, aid_of_word[idx.clamp(min=0).long()], -1)
    neighbor = torch.full((n_aids, k), -1, dtype=torch.int32, device=dev)
    dist = torch.zeros((n_aids, k), dtype=torch.float32, device=dev)
    q_aids = aid_of_word[:first_n].long()
    neighbor[q_aids] = nbr_aid
    dist[q_aids] = -scores   # the score was the negated squared L2
    return KnnTables(neighbor, dist)
