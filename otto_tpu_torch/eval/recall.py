"""Recall@k: of a submission (the OTTO metric) and of a candidate set.

Counterpart of otto_tpu/eval/recall.py. Per type, over the sessions that
have labels of that type: recall = sum(min(hits, 20)) / sum(min(n_labels,
20)), where a hit is a label found among the session's first k predicted
aids; the total weighs clicks, carts and orders 0.1 / 0.3 / 0.6.
`recall_at_k` scores a retrieved candidate set at several cutoffs as if
it were ranked ideally (the retrieval ceiling, C14).
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np

from otto_tpu_torch.config import TYPE2ID, TYPE_WEIGHTS, TYPES
from otto_tpu_torch.data.schema import Labels

TRUTH_CAP = 20


def _hits_per_session(
    pred_sessions: np.ndarray,   # [P] session id per prediction row
    pred_aids: np.ndarray,       # [P, K] predicted aids (-1 pad), rank order
    labels: Labels,
    cutoffs: Sequence[int],
    truth_cap: int = TRUTH_CAP,
) -> Dict[int, Dict[str, float]]:
    """For each type id: {cutoff: recall, ..., 'all': recall over all K
    columns}."""
    out: Dict[int, Dict[str, float]] = {}
    K = pred_aids.shape[1]
    order = np.argsort(pred_sessions, kind="stable")
    ps, pa = pred_sessions[order], pred_aids[order]
    for type_id in (0, 1, 2):
        lab = labels.for_type(type_id)
        if len(lab) == 0:
            out[type_id] = {str(c): 0.0 for c in cutoffs} | {"all": 0.0}
            continue
        lorder = np.lexsort((lab.aid, lab.session))
        ls, la = lab.session[lorder], lab.aid[lorder]
        u_sess, l_sess_idx = np.unique(ls, return_inverse=True)
        true = np.minimum(np.bincount(l_sess_idx), truth_cap)
        # each label's rank in its session's prediction row (K: a miss)
        found_rank = np.full(len(la), K)
        if len(ps):
            p_idx = np.searchsorted(ps, u_sess)
            has_pred = (p_idx < len(ps)) & (ps[np.minimum(p_idx, len(ps) - 1)] == u_sess)
            rows = pa[np.minimum(p_idx[l_sess_idx], len(pa) - 1)]       # [L, K]
            eq = (rows == la[:, None]) & (rows >= 0)
            found_rank = np.where(eq.any(axis=1), eq.argmax(axis=1), K)
            found_rank = np.where(has_pred[l_sess_idx], found_rank, K)
        res = {}
        for c in list(cutoffs) + ["all"]:
            lim = K if c == "all" else min(int(c), K)
            per_sess = np.minimum(
                np.bincount(l_sess_idx[found_rank < lim], minlength=len(u_sess)),
                truth_cap)
            res["all" if c == "all" else str(c)] = float(per_sess.sum()) / float(true.sum())
        out[type_id] = res
    return out


def evaluate_topk(
    pred_by_type: Mapping[str, tuple], labels: Labels, k: int = 20
) -> Dict[str, float]:
    """pred_by_type: type name -> (sessions [N], aids [N, K]) in rank
    order, -1 pad. -> {'clicks', 'carts', 'orders', 'total'}."""
    out: Dict[str, float] = {}
    total = 0.0
    for tname in TYPES:
        sessions, aids = pred_by_type[tname]
        res = _hits_per_session(np.asarray(sessions), np.asarray(aids)[:, :k], labels,
                                cutoffs=(k,))
        out[tname] = res[TYPE2ID[tname]][str(k)]
        total += TYPE_WEIGHTS[tname] * out[tname]
    out["total"] = total
    return out


def evaluate_submission_file(path: str, labels: Labels, k: int = 20) -> Dict[str, float]:
    """evaluate_topk of a written submission CSV, parsed back on its own
    (the cross-check of the file a user would upload)."""
    from otto_tpu_torch.engine.rank import read_submission

    sub = read_submission(path)
    preds = {}
    for tname in TYPES:
        rows = sub.get(tname, {})
        sessions = np.fromiter(rows.keys(), np.int32, len(rows))
        aids = np.full((len(rows), k), -1, np.int32)
        for i, alist in enumerate(rows.values()):
            a = np.asarray(alist[:k], np.int32)
            aids[i, : len(a)] = a
        preds[tname] = (sessions, aids)
    return evaluate_topk(preds, labels, k)


def recall_at_k(
    sessions: np.ndarray,
    aids: np.ndarray,
    labels: Labels,
    cutoffs: Sequence[int] = (20, 100, 200),
) -> Dict[str, Dict[str, float]]:
    """Recall of an ideally ranked candidate set [N, K] at each cutoff and
    over all K columns -> {type: {'top20', ..., 'topall'}} plus 'total'."""
    res = _hits_per_session(sessions, aids, labels, cutoffs=cutoffs)
    keys = [str(c) for c in cutoffs] + ["all"]
    out: Dict[str, Dict[str, float]] = {}
    for tname, tid in TYPE2ID.items():
        out[tname] = {f"top{c}": res[tid][c] for c in keys}
    out["total"] = {f"top{c}": sum(TYPE_WEIGHTS[t] * out[t][f"top{c}"] for t in TYPES)
                    for c in keys}
    return out
