"""Frozen copy of `pack_sessions` and `iter_microbatches` from
`otto_tpu_torch/data/batching.py` at commit 7f160d3: ragged sessions ->
dense padded batches, one per length bucket. The event table is four
(session, ts)-sorted numpy columns here instead of the port's `Events`.
benchmark/tests/test_bench_frozen.py holds the copy equal to the port's.
"""
from __future__ import annotations

from typing import Iterator, List, NamedTuple, Sequence

import numpy as np


class PaddedSessions(NamedTuple):
    """Dense session rows. Padding lanes have aid -1, ts 0, type 0; padding
    rows have session -1 and length 0."""

    session: np.ndarray  # [S]    int32 session ids
    aid: np.ndarray      # [S, L] int32
    ts: np.ndarray       # [S, L] int32
    type: np.ndarray     # [S, L] int32
    length: np.ndarray   # [S]    int32

    @property
    def n_sessions(self) -> int:
        return self.session.shape[0]


def pack_sessions(session: np.ndarray, aid: np.ndarray, ts: np.ndarray, type_: np.ndarray,
                  bucket_lens: Sequence[int] = (8, 32, 128, 512)) -> List[PaddedSessions]:
    """One PaddedSessions per non-empty bucket, sessions in id order; the
    columns must be sorted by (session, ts). Sessions longer than the
    largest bucket keep their last events."""
    sess, starts = np.unique(session, return_index=True)
    ends = np.append(starts[1:], len(session))
    buckets = np.sort(np.asarray(bucket_lens))
    lens = np.minimum(ends - starts, buckets[-1])
    bucket_of = np.searchsorted(buckets, lens)
    out = []
    for bi, L in enumerate(buckets):
        m = bucket_of == bi
        if not m.any():
            continue
        n = lens[m]
        lane = np.arange(L)[None, :]
        pad = lane >= n[:, None]
        # the last n events of each session, left-aligned
        idx = np.where(pad, 0, (ends[m] - n)[:, None] + lane)

        def take(col, fill):
            return np.where(pad, fill, col[idx]).astype(np.int32)

        out.append(PaddedSessions(
            sess[m].astype(np.int32), take(aid, -1), take(ts, 0),
            take(type_, 0), n.astype(np.int32),
        ))
    return out


def iter_microbatches(p: PaddedSessions, batch_size: int) -> Iterator[PaddedSessions]:
    """Batches of `batch_size` rows; the last one padded up to that size."""
    for i in range(0, p.n_sessions, batch_size):
        b = PaddedSessions(*(a[i:i + batch_size] for a in p))
        short = batch_size - b.n_sessions
        if short:
            b = PaddedSessions(*(
                np.concatenate([a, np.full((short,) + a.shape[1:], fill, a.dtype)])
                for a, fill in zip(b, (-1, -1, 0, 0, 0))
            ))
        yield b
