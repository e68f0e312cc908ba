"""Train / test split with labels, as the OTTO organisers carve a test set.

Counterpart of otto_tpu/data/split.py, with the same cuts for the same
seed:

* cutoff = last timestamp - test_days;
* train = events before the cutoff of sessions that start before it;
* test = sessions that start at or after the cutoff, with at least two
  events, each cut at a random index i in [1, len - 1]: events[:i] stay
  visible, events[i:] become labels (clicks: the first future click;
  carts, orders: every distinct future carted / ordered aid).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from otto_tpu_torch.data.schema import Events, Labels

DAY = 24 * 60 * 60


@dataclasses.dataclass
class Split:
    train: Events
    test: Events          # the visible part of the test sessions
    labels: Labels


def split_events(events: Events, test_days: int = 7, seed: int = 42) -> Split:
    ev = events.sort_by_session_ts()
    cutoff = int(ev.ts.max()) - test_days * DAY
    _, starts = np.unique(ev.session, return_index=True)
    lens = np.diff(np.append(starts, len(ev)))
    is_test = ev.ts[starts] >= cutoff
    train = ev.select((ev.ts < cutoff) & ~np.repeat(is_test, lens))

    kept = is_test & (lens >= 2)
    rng = np.random.default_rng(seed)
    n = lens[kept]
    cut = 1 + (rng.random(len(n)) * (n - 1)).astype(np.int64)
    # each kept session's cut as an offset from its start, per event
    cut_of = np.zeros(len(lens), np.int64)
    cut_of[kept] = cut
    pos = np.arange(len(ev)) - np.repeat(starts, lens)
    in_kept = np.repeat(kept, lens)
    visible = in_kept & (pos < np.repeat(cut_of, lens))
    future = ev.select(in_kept & ~visible)
    return Split(train=train, test=ev.select(visible),
                 labels=_labels_from_future(future))


def _labels_from_future(fut: Events) -> Labels:
    """clicks -> the first future click; carts / orders -> every distinct
    future aid, ordered by (session, aid)."""
    fut = fut.sort_by_session_ts()
    s, a, t = fut.session, fut.aid, fut.type
    parts = []
    click = t == 0
    _, first = np.unique(s[click], return_index=True)
    parts.append((s[click][first], np.zeros(len(first), np.int8), a[click][first]))
    for type_id in (1, 2):
        m = t == type_id
        key = np.unique((s[m].astype(np.int64) << 32) | a[m].astype(np.int64))
        parts.append(((key >> 32).astype(np.int32),
                      np.full(len(key), type_id, np.int8),
                      (key & 0xFFFFFFFF).astype(np.int32)))
    return Labels(*(np.concatenate(cols) for cols in zip(*parts)))
