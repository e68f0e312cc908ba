"""Negative downsampling, scoring, top-k selection and the submission file.

Counterpart of otto_tpu/engine/rank.py. Downsampling, per target type:
drop the sessions without a positive and keep at most
min(neg_to_pos_ratio * n_pos, max_neg_per_session) negatives per session,
chosen by a seeded numpy shuffle. Scoring: score every retrieved candidate
with the target's ranker on the device and keep the top-k per session,
for both runners one call a batch for all three (score_topk_multi).
The downsampler and the CSV functions are plain numpy / Python copies of
otto_tpu's (whose module imports jax); tests pin them to the reference's.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from otto_tpu_torch.config import RankerConfig
from otto_tpu_torch.engine.retrieval import FEATURE_NAMES, RetrievedBatch
from otto_tpu_torch.utils import timing


def downsample_select(
    b: RetrievedBatch,
    tgt: np.ndarray,                # [S, C, 3]
    type_id: int,
    cfg: RankerConfig,
    rng: np.random.Generator,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The rows (si, ci) to keep for one type and their labels, or None
    when no session of the batch has a positive. Draws draw_count outputs
    from rng: S * C float64s in the positive case, none otherwise."""
    S, C = b.cand.shape
    valid = b.cand >= 0
    y = tgt[:, :, type_id]
    if not draw_count(valid & (y > 0)):
        return None
    n_pos = (y * valid).sum(axis=1)
    keep_sessions = n_pos > 0
    max_neg = np.minimum(n_pos * cfg.neg_to_pos_ratio, cfg.max_neg_per_session)
    # random priority per negative; keep the max_neg smallest
    prio = rng.random((S, C))
    neg_mask = valid & (y == 0)
    order = np.argsort(np.where(neg_mask, prio, 2.0), axis=1, kind="stable")
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.arange(C)[None, :].repeat(S, 0), axis=1)
    keep_neg = neg_mask & (rank < max_neg[:, None])
    keep = (valid & (y > 0)) | keep_neg
    keep &= keep_sessions[:, None]
    si, ci = np.nonzero(keep)
    return si, ci, y[si, ci]


def downsample_batch(
    b: RetrievedBatch,
    tgt: np.ndarray,
    type_id: int,
    cfg: RankerConfig,
    rng: np.random.Generator,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """One batch of the downsampler -> (feats [n, F] f32, labels [n],
    sessions [n]); the rows are gathered on the device (feats_rows)."""
    got = downsample_select(b, tgt, type_id, cfg, rng)
    if got is None:
        return None
    si, ci, y = got
    return b.feats_rows(si, ci), y, b.session[si]


def rng_at(seed: int, start: int) -> np.random.Generator:
    """default_rng(seed) moved on by `start` 64-bit outputs: where the
    stream stands after drawing `start` float64s with random() (each takes
    one output), without drawing them."""
    bits = np.random.PCG64(seed)
    bits.advance(int(start))
    return np.random.Generator(bits)


def draw_count(pos):
    """The 64-bit outputs downsample_select draws for one type of a batch:
    S * C where some valid candidate is a positive of the type, none
    otherwise. pos: [S, C] bool, valid & positive: a numpy array, or a
    tensor (the count is then a 0-d tensor on its device, no sync)."""
    return pos.any() * (pos.shape[0] * pos.shape[1])


def draw_counts(batches: List[RetrievedBatch], targets: List[np.ndarray],
                type_id: int) -> np.ndarray:
    """[n] int64: each batch's draw_count for the type."""
    return np.array([draw_count((b.cand >= 0) & (t[:, :, type_id] > 0))
                     for b, t in zip(batches, targets)], np.int64)


def draw_starts(counts) -> np.ndarray:
    """Where each batch's draws begin in one stream that serves batches of
    these draw counts in order."""
    counts = np.asarray(counts, np.int64)
    return np.cumsum(counts) - counts


def downsample_parts(
    batches: List[RetrievedBatch],
    targets: List[np.ndarray],      # [S, C, 3] aligned with batches
    type_id: int,
    cfg: RankerConfig,
    starts: Sequence[int],
    seed: int = 42,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The downsampler's rows of each batch in turn -> (feats [N, F],
    labels [N], sessions [N]) in batch order, empty where no batch has a
    positive. Batch i draws from default_rng(seed) moved to starts[i]
    (rng_at): given where each batch's draws begin in one device's order
    (draw_starts), any share of one device's batches keeps its rows."""
    feats_out, lab_out, sess_out = [], [], []
    for b, tgt, start in zip(batches, targets, starts):
        got = downsample_batch(b, tgt, type_id, cfg, rng_at(seed, start))
        if got is None:
            continue
        feats_out.append(got[0])
        lab_out.append(got[1])
        sess_out.append(got[2])
    if not feats_out:
        return (np.zeros((0, len(FEATURE_NAMES)), np.float32), np.zeros(0, np.float32),
                np.zeros(0, np.int32))
    return np.concatenate(feats_out), np.concatenate(lab_out), np.concatenate(sess_out)


def session_sorted(feats, labels, sessions, type_id: int):
    """Rows ordered by session, stably (a session's rows come from one
    batch, in its order); ValueError when there are none."""
    if not len(labels):
        raise ValueError(f"no positive sessions for type {type_id}")
    order = np.argsort(sessions, kind="stable")
    return feats[order], labels[order], sessions[order]


def downsample(
    batches: List[RetrievedBatch],
    targets: List[np.ndarray],      # [S, C, 3] aligned with batches
    type_id: int,
    cfg: RankerConfig,
    seed: int = 42,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (feats [N, F], labels [N], sessions [N]) flat rows, session-sorted:
    one default_rng(seed) stream over the batches in order."""
    starts = draw_starts(draw_counts(batches, targets, type_id))
    return session_sorted(
        *downsample_parts(batches, targets, type_id, cfg, starts, seed), type_id)


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
    """Score one batch with every ranker on the device (one call where
    they are all one multi-task ranker: predict_scores_multi, a task a
    ranker); pull one stacked [n_rankers, S, k] aid array."""
    with timing.span("otto::rank.score"):
        cand = b.cand_device()
        first = rankers[0]
        if (hasattr(first, "predict_scores_multi") and all(r is first for r in rankers)
                and len(first.tasks) == len(rankers)):
            scores = list(first.predict_scores_multi(b))
        else:
            scores = [r.predict_scores_device(b.feats) for r in rankers]
        tops = torch.stack([_topk_program(s, cand, top_k)[1] for s in scores])
    # the pull waits for the card
    with timing.span("otto::rank.pull"):
        return tops.cpu().numpy()


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
