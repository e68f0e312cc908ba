"""Cluster popularity (C12).

Counterpart of otto_tpu/engine/popularity.py. Per (cluster, aid): counts
of clicks / carts / orders, all-time and in the recent window; ordinal
ranks within the cluster (count desc, ties in key order, clipped at
rank_clip); the aids whose best rank is at most keep_top_k become the
cluster's candidates. One cluster for every session is general
popularity.

Events stream through microbatches of P events on the device; each event
emits two tagged lanes (kind = type for all-time, type + 3 when recent)
with key (kind * n_clusters + cluster, aid) into the co-visitation
counter's CountLadder, which spills its runs to host memory; ranks and
tables are built on the host (numpy) from the merged counts and returned
on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from otto_tpu_torch.config import PopularityConfig
from otto_tpu_torch.data.schema import Events
from otto_tpu_torch.device import resolve
from otto_tpu_torch.engine.covis import CountLadder
from otto_tpu_torch.ops import segment as seg
from otto_tpu_torch.ops.counts import CountTable

N_COUNTS = 6  # clicks, carts, orders, clicks_7d, carts_7d, orders_7d
COUNT_NAMES = ("clicks", "carts", "orders", "clicks_7d", "carts_7d", "orders_7d")


class PopularityTables(NamedTuple):
    """candidate [C, T] int32: aids whose best rank <= keep_top_k, -1 pad;
    ranks [C, T, 6] int32: the six rank columns (clip 999) aligned with
    candidate; aid_rank [A, 6] int32: rank lookup for every aid, 999 when
    absent."""

    candidate: torch.Tensor
    ranks: torch.Tensor
    aid_rank: torch.Tensor


def _pop_emit_impl(cluster, aid, type_, ts, ts_7d: int, n_clusters: int) -> CountTable:
    """One microbatch [P] -> a raw tagged count run [2P]: the all-time
    lane of every valid event and the recent lane where ts > ts_7d.
    Padding events carry aid == -1."""
    valid = aid >= 0
    k1a = type_.to(torch.int32) * n_clusters + cluster
    recent = valid & (ts > ts_7d)
    k1 = torch.cat([torch.where(valid, k1a, seg.SENTINEL),
                    torch.where(recent, k1a + 3 * n_clusters, seg.SENTINEL)])
    k2 = torch.cat([torch.where(valid, aid, seg.SENTINEL),
                    torch.where(recent, aid, seg.SENTINEL)])
    cnt = torch.cat([valid, recent]).to(torch.int32)
    return CountTable(k1, k2, cnt, cnt.sum(dtype=torch.int32))


def _segment_starts(sorted_keys: np.ndarray) -> np.ndarray:
    first = np.empty(len(sorted_keys), bool)
    first[0] = True
    np.not_equal(sorted_keys[1:], sorted_keys[:-1], out=first[1:])
    return np.flatnonzero(first)


def _host_pop_tables(
    k1: np.ndarray, k2: np.ndarray, cnt: np.ndarray,
    n_clusters: int, n_aids: int, top_slots: int,
    keep_top_k: int, rank_clip: int,
):
    """Merged tagged counts -> ranks -> dense (candidate, ranks, aid_rank)
    numpy tables."""
    cand = np.full((n_clusters, top_slots), -1, np.int32)
    rank_t = np.full((n_clusters, top_slots, N_COUNTS), rank_clip, np.int32)
    aid_rank = np.full((n_aids, N_COUNTS), rank_clip, np.int32)
    if len(k1) == 0:
        return cand, rank_t, aid_rank

    kind = k1 // n_clusters
    cluster = k1 - kind * n_clusters
    ckey = cluster.astype(np.int64) * n_aids + k2
    # the per-kind slices of the merged stream are (cluster, aid)-sorted
    # already: a stable argsort is a near-linear 6-way run merge
    order = np.argsort(ckey, kind="stable")
    ck_s = ckey[order]
    starts = _segment_starts(ck_s)
    group = np.zeros(len(ck_s), np.int64)
    group[starts] = 1
    group = np.cumsum(group) - 1
    U = len(starts)
    counts = np.zeros((U, N_COUNTS), np.int64)
    counts[group, kind[order]] = cnt[order]
    uk = ck_s[starts]
    ucl = (uk // n_aids).astype(np.int32)
    uaid = (uk - ucl.astype(np.int64) * n_aids).astype(np.int32)

    # per-cluster ordinal ranks, count desc (ucl is ascending already)
    ranks = np.empty((U, N_COUNTS), np.int32)
    pos = np.arange(U, dtype=np.int64)
    for j in range(N_COUNTS):
        o = np.lexsort((-counts[:, j], ucl))
        cl_s = ucl[o]
        st = _segment_starts(cl_s)
        start_of = np.repeat(st, np.diff(np.append(st, U)))
        ranks[o, j] = np.minimum(pos - start_of + 1, rank_clip)

    best = ranks.min(axis=1)
    keep = np.flatnonzero(best <= keep_top_k)
    o = keep[np.lexsort((best[keep], ucl[keep]))]
    cl_s = ucl[o]
    if len(cl_s):
        st = _segment_starts(cl_s)
        start_of = np.repeat(st, np.diff(np.append(st, len(cl_s))))
        slot = np.arange(len(cl_s)) - start_of
        ok = slot < top_slots
        cand[cl_s[ok], slot[ok]] = uaid[o][ok]
        rank_t[cl_s[ok], slot[ok]] = ranks[o][ok]
    aid_rank[uaid] = ranks
    return cand, rank_t, aid_rank


def compute_popularity(
    events: Events,
    session_cluster: np.ndarray,  # cluster id of each event's session, int32
    n_clusters: int,
    n_aids: int,
    cfg: PopularityConfig,
    device,
    top_slots: int = 128,
    event_budget: int = 1 << 22,
) -> PopularityTables:
    """The popularity tables of `events` on `device`. `session_cluster` is
    per event (join cluster-of-session on the host first). Microbatches of
    P events (the next power of two of the event count, at least 8, at
    most `event_budget`; the tail padded with aid -1) feed a spilling
    CountLadder with runs of 2P rows."""
    dev = resolve(device)
    n = len(events.aid)
    ts_7d = (int(events.ts.max()) if n else 0) - cfg.recent_window
    P = min(event_budget, max(8, 1 << (n - 1).bit_length()) if n else 8)
    ladder = CountLadder(
        run_size=2 * P,
        top_capacity=8,
        min_in_part=(1,) * N_COUNTS,
        stride=n_clusters,
        device=dev,
        spill=True,
    )
    cl = np.ascontiguousarray(session_cluster, np.int32)
    try:
        for lo in range(0, max(n, 1), P):
            hi = min(lo + P, n)
            pad = P - (hi - lo)

            def _p(x, fill):
                x = np.asarray(x[lo:hi], np.int32)
                if pad:
                    x = np.pad(x, (0, pad), constant_values=fill)
                return torch.from_numpy(x).to(dev)

            ladder.push(_pop_emit_impl(
                _p(cl, 0), _p(events.aid, -1), _p(events.type, 0),
                _p(events.ts, 0), ts_7d, n_clusters))
        k1, k2, cnt = ladder.host_merged()
    finally:
        ladder.close()
    return PopularityTables(*(
        torch.from_numpy(a).to(dev)
        for a in _host_pop_tables(k1, k2, cnt, n_clusters, n_aids, top_slots,
                                  cfg.keep_top_k, cfg.rank_clip)
    ))
