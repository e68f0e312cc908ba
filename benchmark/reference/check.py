"""The reference's side of `correct` for the serving cells.

`reference_scores` runs the plain reference (frozen retrieval on the
twins of K1 and K2, then every ranker) over a sample of the sessions the
program served, in the program's length buckets. `list_gaps` then holds
each served top-k list to the reference: for every position i of a served
list, the gap by which the reference's score of the served aid lies below
the reference's i-th best score. It returns the widest gap and the share
of positions whose gap exceeds GAP_EPS. A list whose length differs from
min(k, the reference's candidates), or that holds an aid the reference
did not retrieve or holds one twice, is a bad list.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from benchmark.reference import rank
from benchmark.reference.batching import iter_microbatches, pack_sessions
from benchmark.reference.retrieval import RetrievalContext, retrieve_batch

F32 = torch.float32
# a gap above this (in score units; the rankers' scores are of order 0.1-10)
# counts as a position out of the reference's order
GAP_EPS = 1e-6


class RefSession(NamedTuple):
    cand: np.ndarray                   # [n] int32, the valid candidates in slot order
    scores: Dict[str, np.ndarray]      # precision -> [n_rankers, n] float32


def trim_params(retrieval: dict, device) -> torch.Tensor:
    """Retriever.iter_run's [3] float32 recency-trim parameters."""
    hi, lo, at = (retrieval["trim_max_at_order_1"], retrieval["trim_min"],
                  retrieval["trim_min_at_order"])
    return torch.tensor([hi, lo, (hi - lo) / (at - 1)], dtype=F32, device=device)


def reference_scores(cols: Sequence[np.ndarray], cluster_of: Dict[int, int],
                     emb_of: Dict[int, np.ndarray], ctx: RetrievalContext, retrieval: dict,
                     backend: str, rankers: List[Dict], batch: int,
                     precisions: Sequence[str] = ("full",)) -> Dict[int, RefSession]:
    """cols: (session, aid, ts, type) of the sampled sessions, sorted by
    (session, ts); cluster_of / emb_of: each sampled session's cluster and
    embedding. -> {session: RefSession}."""
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
            rows = torch.from_numpy(np.nonzero(real)[0]).to(dev)
            cand, feats = cand[rows], feats[rows]
            S, C, F = feats.shape
            flat = feats.reshape(S * C, F)
            sc = {prec: torch.stack([rank.scores(backend, flat, r, prec).reshape(S, C)
                                     for r in rankers]).cpu().numpy()
                  for prec in precisions}
            cand_h = cand.cpu().numpy()
            for i, s in enumerate(mb.session[real]):
                ok = cand_h[i] >= 0
                out[int(s)] = RefSession(cand_h[i][ok], {p_: v[:, i][:, ok]
                                                         for p_, v in sc.items()})
    return out


def control_lists(ref: Dict[int, RefSession], k: int) -> Dict[int, np.ndarray]:
    """The control's served lists: the top-k of the low-precision scores,
    ties to the lower candidate slot, as the program breaks them."""
    out = {}
    for s, r in ref.items():
        lists = np.full((r.scores["low"].shape[0], k), -1, np.int32)
        for j, row in enumerate(r.scores["low"]):
            order = np.argsort(-row, kind="stable")[:k]
            lists[j, :len(order)] = r.cand[order]
        out[s] = lists
    return out


class Gaps(NamedTuple):
    max_gap: float        # widest gap over every position of every good list
    gapped_share: float   # % of the good lists' positions with a gap above GAP_EPS
    bad_lists: int        # lists of another length, or with an aid not retrieved or repeated
    lists: int            # lists compared


def list_gaps(served: Dict[int, np.ndarray], ref: Dict[int, RefSession], k: int,
              precision: str = "full") -> Gaps:
    """served: {session: [n_rankers, k] aids, -1 padded}."""
    worst, bad, n, positions, gapped = 0.0, 0, 0, 0, 0
    for s, lists in served.items():
        r = ref[s]
        order = np.argsort(r.cand, kind="stable")
        sorted_cand = r.cand[order]
        for j, row in enumerate(lists):
            n += 1
            sc = r.scores[precision][j]
            want = min(k, len(r.cand))
            got = row[row >= 0]
            pos = np.searchsorted(sorted_cand, got)
            found = (pos < len(sorted_cand)) & (sorted_cand[np.minimum(pos, len(sorted_cand) - 1)] == got)
            if (len(got) != want or not np.all(row[:len(got)] >= 0) or not found.all()
                    or len(np.unique(got)) != len(got)):
                bad += 1
                continue
            if not len(got):
                continue
            best = np.sort(sc)[::-1][:len(got)]
            gaps = best - sc[order[pos]]
            worst = max(worst, float(gaps.max()))
            positions += len(gaps)
            gapped += int((gaps > GAP_EPS).sum())
    return Gaps(worst, 100.0 * gapped / max(positions, 1), bad, n)
