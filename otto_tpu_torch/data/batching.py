"""Ragged sessions -> dense padded batches, one per length bucket.

Counterpart of otto_tpu/data/batching.py: sessions become `aid/ts/type
[S, L]` + `length [S]` on the host, bucketed by length so that a short
session is not padded to the longest one (`pack_sessions`,
`iter_microbatches`), or shelf-packed several whole sessions to a row for
co-visitation counting (`pack_sessions_filled`, `iter_filled_microbatches`);
`dedup_events` drops duplicated rows before counting. Sessions longer than
the largest bucket keep their last events.
"""
from __future__ import annotations

from typing import Iterator, List, NamedTuple, Sequence, Tuple

import numpy as np

from otto_tpu_torch.data.schema import Events


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

    @property
    def max_len(self) -> int:
        return self.aid.shape[1]


def _session_spans(ev: Events) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(session_ids, start, end) over a session-sorted event table."""
    sess, starts = np.unique(ev.session, return_index=True)
    ends = np.append(starts[1:], len(ev))
    return sess, starts, ends


def pack_sessions(
    ev: Events, bucket_lens: Sequence[int] = (8, 32, 128, 512)
) -> List[PaddedSessions]:
    """One PaddedSessions per non-empty bucket, sessions in id order."""
    ev = ev.sort_by_session_ts()
    sess, starts, ends = _session_spans(ev)
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
            sess[m].astype(np.int32), take(ev.aid, -1), take(ev.ts, 0),
            take(ev.type, 0), n.astype(np.int32),
        ))
    return out


def iter_microbatches(
    p: PaddedSessions, batch_size: int
) -> Iterator[PaddedSessions]:
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


class FilledSessions(NamedTuple):
    """Dense rows holding several whole sessions each (shelf packing); the
    lane-wise `sess` id lets pair emission mask cross-session cells."""

    aid: np.ndarray   # [S, L] int32, -1 padding
    ts: np.ndarray    # [S, L] int32, 0 padding
    type: np.ndarray  # [S, L] int32, 0 padding
    sess: np.ndarray  # [S, L] int32 session id per lane, -1 padding

    @property
    def n_rows(self) -> int:
        return self.aid.shape[0]

    @property
    def max_len(self) -> int:
        return self.aid.shape[1]


def pack_sessions_filled(
    ev: Events, bucket_lens: Sequence[int] = (32, 512)
) -> List[FilledSessions]:
    """Shelf-pack whole sessions, several per row, one batch per bucket.

    Sessions are classed by exact length l (ascending); a class packs
    floor(L / l) sessions per row. Sessions longer than the largest bucket
    keep their last max(bucket_lens) events, as in pack_sessions."""
    ev = ev.sort_by_session_ts()
    sess, starts, ends = _session_spans(ev)
    buckets = np.asarray(sorted(bucket_lens))
    lens_c = np.minimum((ends - starts).astype(np.int64), int(buckets[-1]))
    bucket_of = np.searchsorted(buckets, lens_c)

    out: List[FilledSessions] = []
    for bi, L in enumerate(buckets):
        m = bucket_of == bi
        if not m.any():
            continue
        b_sess = sess[m].astype(np.int32)
        b_lens = lens_c[m]
        gstart = ends[m] - b_lens

        # per length class: row index + column offset by reshape arithmetic
        row_id = np.empty(len(b_sess), np.int64)
        col_off = np.empty(len(b_sess), np.int64)
        base_row = 0
        for l_val in np.unique(b_lens):
            idx = np.nonzero(b_lens == l_val)[0]
            k = max(1, int(L // l_val))
            seq = np.arange(len(idx))
            row_id[idx] = base_row + seq // k
            col_off[idx] = (seq % k) * l_val
            base_row += -(-len(idx) // k)

        S = int(base_row)
        tot = int(b_lens.sum())
        within = np.arange(tot) - np.repeat(
            np.concatenate([[0], np.cumsum(b_lens)[:-1]]), b_lens
        )
        src = np.repeat(gstart, b_lens) + within
        dst = np.repeat(row_id * L + col_off, b_lens) + within

        aid = np.full(S * L, -1, np.int32)
        ts_ = np.zeros(S * L, np.int32)
        typ = np.zeros(S * L, np.int32)
        sid = np.full(S * L, -1, np.int32)
        aid[dst] = ev.aid[src]
        ts_[dst] = ev.ts[src]
        typ[dst] = ev.type[src]
        sid[dst] = np.repeat(b_sess, b_lens)
        out.append(FilledSessions(
            aid.reshape(S, L), ts_.reshape(S, L),
            typ.reshape(S, L), sid.reshape(S, L),
        ))
    return out


def pad_filled(p: FilledSessions, to_rows: int) -> FilledSessions:
    """Pad the row axis up to `to_rows` with empty rows."""
    short = to_rows - p.n_rows
    if short == 0:
        return p
    if short < 0:
        raise ValueError(f"pad_filled: {p.n_rows} rows > {to_rows}")
    return FilledSessions(*(
        np.concatenate([a, np.full((short, p.max_len), fill, a.dtype)])
        for a, fill in zip(p, (-1, 0, 0, -1))
    ))


def iter_filled_microbatches(
    p: FilledSessions, batch_size: int
) -> Iterator[FilledSessions]:
    """Batches of `batch_size` rows; the last one padded up to that size."""
    for i in range(0, p.n_rows, batch_size):
        yield pad_filled(FilledSessions(*(a[i:i + batch_size] for a in p)),
                         batch_size)


def dedup_events(ev: Events) -> Events:
    """Drop exactly duplicated (session, aid, ts, type) rows, keeping the
    first of each in table order. When (aid, ts, type) fit 62 bits they
    pack into one int64 minor key (one lexsort pass fewer)."""
    a64 = ev.aid.astype(np.int64)
    t64 = ev.ts.astype(np.int64)
    y64 = ev.type.astype(np.int64)
    if (
        len(ev)
        and 0 <= a64.min()
        and a64.max() < (1 << 29)
        and 0 <= t64.min()
        and t64.max() < (1 << 31)
        and 0 <= y64.min()
        and y64.max() < 4
    ):
        packed = (a64 << 33) | (t64 << 2) | y64
        order = np.lexsort((packed, ev.session))
        s = ev.session[order]
        p = packed[order]
        first = np.empty(len(order), bool)
        first[:1] = True
        first[1:] = (s[1:] != s[:-1]) | (p[1:] != p[:-1])
    else:
        order = np.lexsort((ev.type, ev.ts, ev.aid, ev.session))
        s = ev.session[order]
        a = ev.aid[order]
        t = ev.ts[order]
        ty = ev.type[order]
        first = np.empty(len(order), bool)
        first[:1] = True
        first[1:] = (
            (s[1:] != s[:-1]) | (a[1:] != a[:-1]) | (t[1:] != t[:-1])
            | (ty[1:] != ty[:-1])
        )
    idx = order[first]
    idx.sort()
    return ev.select(idx)
