"""Host helpers of the ranker: the ndcg@k eval metric and session grouping.

Counterparts of otto_tpu/models/ranker.py's `ndcg_at_k` and `_group_pad`,
which the GBDT trainer reads (plain numpy copies; otto_tpu's module imports
jax). The MLP tower of that module is not ported yet: `ranker_backend=
"mlp"` raises in the port's pipeline.
"""
from __future__ import annotations

import numpy as np


def ndcg_at_k(
    scores: np.ndarray, labels: np.ndarray, mask: np.ndarray, k: int = 20
) -> float:
    """Mean NDCG@k over the groups [NG, G] with at least one positive."""
    s = np.where(mask, scores, -np.inf)
    y = np.where(mask, labels, 0.0)
    k = min(k, s.shape[1])
    order = np.argsort(-s, axis=1)[:, :k]
    top_y = np.take_along_axis(y, order, axis=1)
    disc = 1.0 / np.log2(2.0 + np.arange(k))
    dcg = (top_y * disc[None, :]).sum(axis=1)
    n_pos = y.sum(axis=1).astype(np.int64)
    has_pos = n_pos > 0
    ideal = np.array(
        [disc[: min(n, k)].sum() if n > 0 else 1.0 for n in n_pos]
    )
    return float((dcg[has_pos] / ideal[has_pos]).mean()) if has_pos.any() else 0.0


def _group_slots(labels, sessions, max_group):
    """Where `_group_pad` puts each row: -> (rows [K], slots [K] =
    group * max_group + position, n_groups); rows past max_group in their
    group are left out."""
    order = np.lexsort((-labels, sessions))
    s_s = sessions[order]
    u_sess, starts = np.unique(s_s, return_index=True)
    gi = np.searchsorted(u_sess, s_s)
    pos = np.arange(len(s_s)) - starts[gi]
    keep = pos < max_group
    return order[keep], gi[keep] * max_group + pos[keep], len(u_sess)


def _group_pad(feats, labels, sessions, max_group):
    """[N, F] rows -> ([n_groups, max_group, F] features, [n_groups,
    max_group] labels, mask), one group per session in ascending session
    order. A group longer than max_group keeps its positives first."""
    rows, slots, n_g = _group_slots(labels, sessions, max_group)
    F = feats.shape[1]
    # uint8 bins and float16 rows pad in their own dtype
    fdt = feats.dtype if feats.dtype in (np.uint8, np.float16) else np.float32
    fg = np.zeros((n_g * max_group, F), fdt)
    lg = np.zeros(n_g * max_group, np.float32)
    mg = np.zeros(n_g * max_group, bool)
    fg[slots] = feats[rows]
    lg[slots] = labels[rows]
    mg[slots] = True
    return (fg.reshape(n_g, max_group, F), lg.reshape(n_g, max_group),
            mg.reshape(n_g, max_group))
