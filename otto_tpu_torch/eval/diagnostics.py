"""Label-free quality diagnostics (numpy on the host).

Counterpart of otto_tpu/eval/diagnostics.py: the overlap of an aid's w2vec
kNN neighbours with its co-visitation neighbours, averaged over sampled
aids that have both. Healthy embeddings recover a large share of strong
co-visitation neighbours; an overlap near zero means the embedding run
failed, whatever the recall says.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def w2vec_covis_overlap(
    knn_neighbor: np.ndarray,    # [A, k] w2vec kNN table (-1 pad)
    covis_neighbor: np.ndarray,  # [A, N] co-count top-N table (-1 pad)
    n_sample: int = 200,
    cap: int = 20,
    seed: int = 42,
) -> Dict[str, float]:
    """Mean overlap over up to `n_sample` aids having both neighbour sets:
    per aid |co ∩ w2v| / min(cap, |co|) ('co_count_x_w2vec'), the reverse
    share of w2v neighbours backed by co-counts ('w2vec_x_co_count'), the
    number of aids compared and the share of aids that have both."""
    knn_neighbor = np.asarray(knn_neighbor)
    covis_neighbor = np.asarray(covis_neighbor)
    A = min(len(knn_neighbor), len(covis_neighbor))
    has_w2v = (knn_neighbor[:A] >= 0).any(axis=1)
    has_co = (covis_neighbor[:A] >= 0).any(axis=1)
    both = np.flatnonzero(has_w2v & has_co)
    if len(both) == 0:
        return {"co_count_x_w2vec": 0.0, "w2vec_x_co_count": 0.0,
                "n_aids_compared": 0, "coverage_both": 0.0}
    rng = np.random.default_rng(seed)
    pick = both if len(both) <= n_sample else rng.choice(both, n_sample, replace=False)
    co = covis_neighbor[pick][:, :cap]
    wv = knn_neighbor[pick][:, :cap]
    co_valid = co >= 0
    wv_valid = wv >= 0
    # [n, N', k'] membership grid (N', k' <= cap: small)
    hit = (co[:, :, None] == wv[:, None, :]) & co_valid[:, :, None] & wv_valid[:, None, :]
    inter = hit.any(axis=2).sum(axis=1)
    inter_rev = hit.any(axis=1).sum(axis=1)
    n_co = np.minimum(co_valid.sum(axis=1), cap)
    n_wv = np.minimum(wv_valid.sum(axis=1), cap)
    return {
        "co_count_x_w2vec": float(np.mean(inter / np.maximum(n_co, 1))),
        "w2vec_x_co_count": float(np.mean(inter_rev / np.maximum(n_wv, 1))),
        "n_aids_compared": int(len(pick)),
        "coverage_both": float(len(both) / max(A, 1)),
    }


def write_overlap_report(path: str, stats: Dict[str, float]) -> None:
    """The stats as a two-line CSV (header, values)."""
    with open(path, "w") as fh:
        fh.write(",".join(stats.keys()) + "\n")
        fh.write(",".join(f"{v:.6g}" if isinstance(v, float) else str(v)
                          for v in stats.values()) + "\n")
