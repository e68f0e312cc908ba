"""Recall@k of a submission, the OTTO metric.

Counterpart of otto_tpu/eval/recall.py's `evaluate_topk`: per type, over
the sessions that have labels of that type,
recall = sum(min(hits, 20)) / sum(min(n_labels, 20)), where a hit is a
label found among the session's top-k predicted aids; the total weighs
clicks, carts and orders 0.1 / 0.3 / 0.6.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from otto_tpu_torch.config import TYPE2ID, TYPE_WEIGHTS, TYPES
from otto_tpu_torch.data.schema import Labels

TRUTH_CAP = 20


def _recall(sessions: np.ndarray, aids: np.ndarray, lab: Labels) -> float:
    """sessions [N], aids [N, k] (-1 pad) against one type's labels."""
    if len(lab) == 0 or len(sessions) == 0:
        return 0.0
    order = np.argsort(sessions, kind="stable")
    ps, pa = sessions[order], aids[order]
    u_sess, of_sess = np.unique(lab.session, return_inverse=True)
    true = np.minimum(np.bincount(of_sess), TRUTH_CAP)
    row = np.minimum(np.searchsorted(ps, lab.session), len(ps) - 1)
    found = ((pa[row] == lab.aid[:, None]) & (pa[row] >= 0)).any(axis=1)
    hit = found & (ps[row] == lab.session)
    per_sess = np.minimum(np.bincount(of_sess[hit], minlength=len(u_sess)),
                          TRUTH_CAP)
    return float(per_sess.sum()) / float(true.sum())


def evaluate_topk(
    pred_by_type: Mapping[str, tuple], labels: Labels, k: int = 20
) -> Dict[str, float]:
    """pred_by_type: type name -> (sessions [N], aids [N, K]) in rank
    order, -1 pad. -> {'clicks', 'carts', 'orders', 'total'}."""
    out: Dict[str, float] = {}
    total = 0.0
    for tname in TYPES:
        sessions, aids = pred_by_type[tname]
        out[tname] = _recall(np.asarray(sessions), np.asarray(aids)[:, :k],
                             labels.for_type(TYPE2ID[tname]))
        total += TYPE_WEIGHTS[tname] * out[tname]
    out["total"] = total
    return out
