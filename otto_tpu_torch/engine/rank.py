"""Scoring, top-k selection and the submission file.

Counterpart of the serving half of otto_tpu/engine/rank.py: score every
retrieved candidate with the target's ranker on the device, keep the top-k
per session, write / read the Kaggle submission CSV. The CSV functions are
plain Python copies of otto_tpu's (whose module imports jax); a test pins
their bytes to the reference's.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from otto_tpu_torch.engine.retrieval import RetrievedBatch


def _topk_program(scores: torch.Tensor, cand: torch.Tensor, k: int):
    """Top-k of scores [S, C] among the valid candidates (cand >= 0).
    Ties go to the lower candidate index, as `jax.lax.top_k` breaks them:
    a stable descending sort, sliced (torch.topk promises no tie order on
    CUDA). Slots past the valid candidates get aid -1."""
    s = torch.where(cand >= 0, scores, -torch.inf)
    top_s, idx = torch.sort(s, dim=1, descending=True, stable=True)
    top_s, idx = top_s[:, :k], idx[:, :k]
    top_a = torch.gather(cand, 1, idx)
    return top_s, torch.where(torch.isfinite(top_s), top_a, -1)


def score_topk_multi(
    b: RetrievedBatch, rankers: List, top_k: int = 20
) -> np.ndarray:
    """Score one batch with every ranker on the device; pull one stacked
    [n_rankers, S, k] aid array."""
    cand = b.cand_device()
    tops = [
        _topk_program(r.predict_scores_device(b.feats), cand, top_k)[1]
        for r in rankers
    ]
    return torch.stack(tops).cpu().numpy()


def score_and_topk(
    batches: List[RetrievedBatch], ranker, top_k: int = 20
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (sessions [N], top-k aids [N, k] rank-ordered, scores [N, k]),
    session-sorted."""
    sess_out, aid_out, score_out = [], [], []
    for b in batches:
        scores = ranker.predict_scores_device(b.feats)
        top_s, top_a = _topk_program(scores, b.cand_device(), top_k)
        sess_out.append(b.session)
        aid_out.append(top_a.cpu().numpy())
        score_out.append(top_s.cpu().numpy())
    sessions = np.concatenate(sess_out)
    order = np.argsort(sessions, kind="stable")
    return (
        sessions[order],
        np.concatenate(aid_out)[order],
        np.concatenate(score_out)[order],
    )


def write_submission(
    path: str,
    preds_by_type: dict,   # type name -> (sessions [N], aids [N, k])
) -> None:
    """Kaggle CSV `session_type,labels`."""
    with open(path, "w") as fh:
        fh.write("session_type,labels\n")
        rows = []
        for tname, (sessions, aids) in preds_by_type.items():
            for s, row in zip(sessions, aids):
                labels = " ".join(str(int(a)) for a in row if a >= 0)
                rows.append((f"{int(s)}_{tname}", labels))
        rows.sort()
        for st, labels in rows:
            fh.write(f"{st},{labels}\n")


def read_submission(path: str) -> dict:
    """Parse back a submission CSV -> {type name: {session: [aids]}}."""
    out = {}
    with open(path) as fh:
        next(fh)
        for line in fh:
            st, labels = line.rstrip("\n").split(",", 1)
            s, tname = st.rsplit("_", 1)
            aids = [int(a) for a in labels.split()] if labels else []
            out.setdefault(tname, {})[int(s)] = aids
    return out
