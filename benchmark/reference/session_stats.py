"""Frozen copy of `otto_tpu_torch/engine/session_stats.py` at commit 7f160d3 (the
benchmark's plain reference: retrieval Stage A). It imports nothing of
otto_tpu_torch, so later changes to the port cannot move the yardstick;
benchmark/tests/test_bench_frozen.py holds its output equal to the
port's at a tiny size.

The original docstring follows.

Per-session and per-(session, aid) statistics (Stage A of retrieval).

Counterpart of otto_tpu/engine/session_stats.py: from padded session
tensors [S, L] produce per-session scalars and per-unique-aid stats
[S, A_k], compacted to the A_k most recent unique aids. Absent int stats
carry NULL (-1) once finished; intermediate reductions use the SENTINEL /
NEG_SENTINEL identities.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import segment as seg

SENT = seg.SENTINEL
NEG_SENT = seg.NEG_SENTINEL
NULL = -1
HOUR = 60 * 60
I32 = torch.int32


class SessionStats(NamedTuple):
    """Per-session scalars [S]."""

    n_events: torch.Tensor
    n_aids: torch.Tensor         # unique aids
    n_clicks: torch.Tensor
    n_carts: torch.Tensor
    n_orders: torch.Tensor
    min_ts: torch.Tensor
    max_ts: torch.Tensor
    duration: torch.Tensor
    only_orders: torch.Tensor    # int32 0/1


class SessionAids(NamedTuple):
    """Per kept unique (session, aid) stats [S, A_k]."""

    aid: torch.Tensor                 # -1 pad
    n_aid: torch.Tensor
    n_aid_clicks: torch.Tensor
    n_aid_carts: torch.Tensor
    n_aid_orders: torch.Tensor
    rank_by_n_aid: torch.Tensor
    rank_by_n_aid_carts: torch.Tensor
    rank_by_n_aid_orders: torch.Tensor
    max_ts_aid: torch.Tensor          # NULL when absent
    max_ts_aid_clicks: torch.Tensor
    max_ts_aid_carts: torch.Tensor
    max_ts_aid_orders: torch.Tensor
    ts_aid_rel_pos_in_session: torch.Tensor
    ts_order_aid: torch.Tensor        # 1 = most recent
    ts_order_aid_rel: torch.Tensor
    ts_order_aid_clicks: torch.Tensor
    ts_order_aid_carts: torch.Tensor
    ts_order_aid_orders: torch.Tensor
    left_in_cart: torch.Tensor

    @property
    def valid(self) -> torch.Tensor:
        """[S, A_k] bool: the slots that hold an aid."""
        return self.aid >= 0


def compute_session_stats(aid, ts, type_) -> SessionStats:
    valid = aid >= 0
    n_events = valid.sum(dim=1, dtype=I32)
    n_clicks = (valid & (type_ == 0)).sum(dim=1, dtype=I32)
    n_carts = (valid & (type_ == 1)).sum(dim=1, dtype=I32)
    n_orders = (valid & (type_ == 2)).sum(dim=1, dtype=I32)
    big = 2**30
    min_ts = torch.where(valid, ts, big).amin(dim=1)
    max_ts = torch.where(valid, ts, -big).amax(dim=1)
    # unique aid count per session via a row sort
    (ks,), _ = seg.rowwise_sort((torch.where(valid, aid, SENT),))
    first = (ks != seg._prev(ks, NEG_SENT)) & (ks != SENT)
    n_aids = first.sum(dim=1, dtype=I32)
    only_orders = ((n_clicks == 0) & (n_carts == 0) & (n_orders > 0)).to(I32)
    return SessionStats(
        n_events, n_aids, n_clicks, n_carts, n_orders,
        min_ts, max_ts, max_ts - min_ts, only_orders,
    )


def compute_session_aids(aid, ts, type_, keep_aids: int) -> SessionAids:
    """[S, L] events -> [S, keep_aids] per-unique-aid stats, most recent
    first."""
    valid = aid >= 0
    key = torch.where(valid, aid, SENT)
    is_c = valid & (type_ == 0)
    is_k = valid & (type_ == 1)
    is_o = valid & (type_ == 2)

    def ts_of(mask):
        return torch.where(mask, ts, NEG_SENT)

    uk, red, _ = seg.rowwise_groupby(
        key,
        {
            "n": (valid.to(I32), "sum"),
            "n_c": (is_c.to(I32), "sum"),
            "n_k": (is_k.to(I32), "sum"),
            "n_o": (is_o.to(I32), "sum"),
            "mt": (ts_of(valid), "max"),
            "mt_c": (ts_of(is_c), "max"),
            "mt_k": (ts_of(is_k), "max"),
            "mt_o": (ts_of(is_o), "max"),
        },
    )
    u_valid = uk != SENT

    # per-type recency orders over the session
    def order_of(mts):
        has = u_valid & (mts != NEG_SENT)
        return seg.rowwise_rank_desc(torch.where(has, mts, 0), has)

    ts_order = order_of(red["mt"])
    ts_order_c = order_of(red["mt_c"])
    ts_order_k = order_of(red["mt_k"])
    ts_order_o = order_of(red["mt_o"])

    rank_n = seg.rowwise_rank_desc(red["n"], u_valid)
    rank_nk = seg.rowwise_rank_desc(red["n_k"], u_valid)
    rank_no = seg.rowwise_rank_desc(red["n_o"], u_valid)

    n_uniq = torch.clamp(torch.where(u_valid, ts_order, 0).amax(dim=1), min=1)
    ts_order_rel = torch.where(
        u_valid,
        (ts_order.float() / n_uniq[:, None].float() * 100).round().to(I32),
        SENT,
    )

    # rel pos of the aid's last ts inside the session span
    mt = red["mt"]
    min_mt = torch.where(u_valid, mt, 2**30).amin(dim=1, keepdim=True)
    max_mt = torch.where(u_valid, mt, -(2**30)).amax(dim=1, keepdim=True)
    span = torch.clamp(max_mt - min_mt, min=HOUR).float()
    rel_pos = torch.where(
        u_valid, ((max_mt - mt).float() / span * 100).round().to(I32), SENT
    )

    left_in_cart = (
        u_valid
        & (
            ((red["n_k"] > 0) & (red["n_o"] == 0))
            | (
                (red["mt_k"] != NEG_SENT)
                & (red["mt_o"] != NEG_SENT)
                & (red["mt_k"] > red["mt_o"])
            )
        )
    ).to(I32)

    # compact: keep the most recent `keep_aids` unique aids
    sort_key = torch.where(u_valid, ts_order, SENT)
    cols = [
        uk, red["n"], red["n_c"], red["n_k"], red["n_o"],
        rank_n, rank_nk, rank_no,
        red["mt"], red["mt_c"], red["mt_k"], red["mt_o"],
        rel_pos, ts_order, ts_order_rel, ts_order_c, ts_order_k, ts_order_o,
        left_in_cart,
    ]
    (sk,), sorted_cols = seg.rowwise_sort((sort_key,), cols)
    kept = [c[:, :keep_aids] for c in sorted_cols]
    ok = sk[:, :keep_aids] != SENT

    def fin(x):
        """reducer identities -> NULL, invalid lanes masked"""
        x = torch.where((x == NEG_SENT) | (x == SENT), NULL, x)
        return torch.where(ok, x, NULL)

    def zero_pad(x):
        return torch.where(ok, x, 0)

    return SessionAids(
        aid=torch.where(ok, kept[0], -1),
        n_aid=zero_pad(kept[1]),
        n_aid_clicks=zero_pad(kept[2]),
        n_aid_carts=zero_pad(kept[3]),
        n_aid_orders=zero_pad(kept[4]),
        rank_by_n_aid=fin(kept[5]),
        rank_by_n_aid_carts=fin(kept[6]),
        rank_by_n_aid_orders=fin(kept[7]),
        max_ts_aid=fin(kept[8]),
        max_ts_aid_clicks=fin(kept[9]),
        max_ts_aid_carts=fin(kept[10]),
        max_ts_aid_orders=fin(kept[11]),
        ts_aid_rel_pos_in_session=fin(kept[12]),
        ts_order_aid=fin(kept[13]),
        ts_order_aid_rel=fin(kept[14]),
        ts_order_aid_clicks=fin(kept[15]),
        ts_order_aid_carts=fin(kept[16]),
        ts_order_aid_orders=fin(kept[17]),
        left_in_cart=zero_pad(kept[18]),
    )
