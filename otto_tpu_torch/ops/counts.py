"""Sparse (aid, aid_next) -> count accumulation.

Counterpart of otto_tpu/ops/counts.py, in two halves.

The device half: a CountTable is a sorted sparse table of int32 tensors
on one device, rows >= n padding (aid == SENTINEL). Merges concatenate,
sort by (aid, aid_next) and sum duplicates (ops/segment.py's flat
groupbys); a bounded table that overflows keeps its largest counts.
otto_tpu's `lax.cond` on the unique count becomes a Python `if` on it:
one device sync.

The host half (numpy): fully merged runs spilled from the device are
kept as sorted int64 key runs (`HostRunStore`) and merged there, by the
C++ two-way merge of `native/kmerge.cc` when a host compiler can build
it at first use, else by a numpy stable sort; both give the same table.
`host_finalize` and `host_topn_tables` prune and tabulate on the host.
"""
from __future__ import annotations

import ctypes
import functools
import logging
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from otto_tpu_torch.ops import segment as seg
from otto_tpu_torch.ops.kernels import _build

log = logging.getLogger(__name__)

SENTINEL = seg.SENTINEL
I32 = torch.int32


class CountTable(NamedTuple):
    """Sorted sparse count table; rows >= n are padding (aid == SENTINEL).
    Device tables hold tensors (n a 0-d int32 tensor); tables merged on
    the host hold numpy arrays."""

    aid: torch.Tensor        # [C] int32 ascending (SENTINEL padded)
    aid_next: torch.Tensor   # [C] int32
    count: torch.Tensor      # [C] int32
    n: torch.Tensor          # []  int32 number of valid rows

    @property
    def capacity(self) -> int:
        return self.aid.shape[0]


def empty_table(capacity: int, device) -> CountTable:
    return CountTable(
        aid=torch.full((capacity,), SENTINEL, dtype=I32, device=device),
        aid_next=torch.full((capacity,), SENTINEL, dtype=I32, device=device),
        count=torch.zeros((capacity,), dtype=I32, device=device),
        n=torch.zeros((), dtype=I32, device=device),
    )


def _sort_by_pair(a, b, c):
    """(a, b, c) sorted by (a, b); equal keys only on SENTINEL padding."""
    a_s, b_s, _, perm = seg._sort_pairs(a, b)
    return a_s, b_s, c[perm]


def _keep_topk_by_count(
    aid: torch.Tensor, aid_next: torch.Tensor, count: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the k largest-count rows (ties in row order), back in key
    order; zero-count rows become padding."""
    _, perm = torch.sort(-count, stable=True)
    perm = perm[:k]
    c_k = count[perm]
    pad = c_k == 0
    a_k = torch.where(pad, SENTINEL, aid[perm])
    b_k = torch.where(pad, SENTINEL, aid_next[perm])
    a_o, b_o, c_o = _sort_by_pair(a_k, b_k, c_k)
    return a_o, b_o, torch.where(a_o == SENTINEL, 0, c_o)


def _cat(runs: Sequence[CountTable]):
    return tuple(torch.cat([getattr(r, f) for r in runs])
                 for f in ("aid", "aid_next", "count"))


def merge_into(
    table: CountTable,
    aid: torch.Tensor,
    aid_next: torch.Tensor,
    count: torch.Tensor,
) -> CountTable:
    """Merge a batch of pair counts into the table; batch rows with aid ==
    SENTINEL or count == 0 are ignored. On overflow the smallest counts
    are dropped."""
    C = table.capacity
    valid = (aid != SENTINEL) & (count > 0)
    k1 = torch.cat([table.aid, torch.where(valid, aid, SENTINEL)])
    k2 = torch.cat([table.aid_next, torch.where(valid, aid_next, SENTINEL)])
    v = torch.cat([table.count, torch.where(valid, count, 0)])
    uk1, uk2, uv, n_unique = seg.sort_compress(k1, k2, v)
    if int(n_unique) > C:
        a, b, c = _keep_topk_by_count(uk1, uk2, uv, C)
    else:
        a, b, c = uk1[:C], uk2[:C], uv[:C]
    return CountTable(a, b, c, n_unique.clamp(max=C))


def merge_runs(runs: Sequence[CountTable]) -> CountTable:
    """Lossless merge of runs (capacity = the sum of theirs), left
    uncompacted: unique keys at their segment-end rows."""
    return CountTable(*seg.sort_compress_ends(*_cat(runs)))


def merge_runs_compact(runs: Sequence[CountTable]) -> CountTable:
    """merge_runs with the uniques packed at the front in key order, so the
    result can be sliced down to its occupancy."""
    return CountTable(*seg.sort_compress(*_cat(runs)))


def merge_runs_compact_raw(runs: Sequence[CountTable]) -> CountTable:
    """merge_runs_compact of RAW runs (count == 1 on every row with aid !=
    SENTINEL, as pair emission makes them): a keys-only sort, the counts
    are segment lengths. The count column is not read, so an aggregated
    run passed here gets wrong counts."""
    k1 = torch.cat([r.aid for r in runs])
    k2 = torch.cat([r.aid_next for r in runs])
    k1s, k2s, first, _ = seg._sort_pairs(k1, k2)
    pos = torch.arange(k1s.shape[0], device=k1s.device)
    length = (pos - seg._segment_start_index(first) + 1).to(I32)
    is_end = seg._next(first, True) & (k1s != SENTINEL)
    uk1, uk2, uv = seg._compact(is_end, [k1s, k2s, length], [SENTINEL, SENTINEL, 0])
    return CountTable(uk1, uk2, uv, is_end.sum(dtype=I32))


def slice_table(t: CountTable, size: int) -> CountTable:
    """First `size` rows of a compacted table (the caller knows n <= size)."""
    return CountTable(t.aid[:size], t.aid_next[:size], t.count[:size], t.n)


def _select_by_tag(tag: torch.Tensor, values: Tuple[int, ...]) -> torch.Tensor:
    """values[tag], values[0] for a tag past the end."""
    out = torch.full(tag.shape, values[0] if values else 0, dtype=I32,
                     device=tag.device)
    for i, val in enumerate(values):
        out = torch.where(tag == i, val, out)
    return out


def _min_in_part(aid: torch.Tensor, min_count_in_part, stride: int) -> torch.Tensor:
    tag = torch.where(aid == SENTINEL, 0, torch.div(aid, stride, rounding_mode="floor"))
    return _select_by_tag(tag, min_count_in_part)


def merge_bounded_tagged(
    table: CountTable,
    run: CountTable,
    min_count_in_part: Tuple[int, ...],
    stride: int,
) -> CountTable:
    """Merge a run into the bounded table of the type-tagged key space. On
    overflow, first drop pairs below their type's in-part min count, then
    keep the largest counts."""
    C = table.capacity
    uk1, uk2, uv, n_unique = seg.sort_compress(*_cat((table, run)))
    if int(n_unique) > C:
        keep = uv >= _min_in_part(uk1, min_count_in_part, stride)
        a, b, c = _keep_topk_by_count(
            torch.where(keep, uk1, SENTINEL), torch.where(keep, uk2, SENTINEL),
            torch.where(keep, uv, 0), C)
    else:
        a, b, c = uk1[:C], uk2[:C], uv[:C]
    return CountTable(a, b, c, (c[:C] > 0).sum(dtype=I32))


def prune_tagged(
    table: CountTable, min_count_in_part: Tuple[int, ...], stride: int
) -> CountTable:
    """Drop rows below their type's in-part min count; the rest front-
    packed in key order."""
    keep = (table.aid != SENTINEL) & (
        table.count >= _min_in_part(table.aid, min_count_in_part, stride))
    a, b, c = _sort_by_pair(
        torch.where(keep, table.aid, SENTINEL),
        torch.where(keep, table.aid_next, SENTINEL),
        torch.where(keep, table.count, 0))
    return CountTable(a, b, c, keep.sum(dtype=I32))


def extract_tag(table: CountTable, tag: int, stride: int,
                capacity: int) -> CountTable:
    """One count type's rows of a tagged table as an untagged table of
    `capacity` rows (the smallest counts dropped on overflow)."""
    in_tag = (table.aid != SENTINEL) & (
        torch.div(table.aid, stride, rounding_mode="floor") == tag)
    a, b, c = _sort_by_pair(
        torch.where(in_tag, table.aid - tag * stride, SENTINEL),
        torch.where(in_tag, table.aid_next, SENTINEL),
        torch.where(in_tag, table.count, 0))
    n_t = in_tag.sum(dtype=I32)
    C = capacity
    if table.capacity <= C:
        pad = C - table.capacity
        return CountTable(
            torch.cat([a, a.new_full((pad,), SENTINEL)]),
            torch.cat([b, b.new_full((pad,), SENTINEL)]),
            torch.cat([c, c.new_zeros(pad)]),
            n_t,
        )
    if int(n_t) > C:
        a, b, c = _keep_topk_by_count(a, b, c, C)
    else:
        a, b, c = a[:C], b[:C], c[:C]
    return CountTable(a, b, c, n_t.clamp(max=C))


def finalize(table: CountTable, min_count: int, max_pairs: int) -> CountTable:
    """The global prune: count >= min_count, then the top max_pairs by
    count."""
    c = torch.where(table.count >= min_count, table.count, 0)
    a = torch.where(c > 0, table.aid, SENTINEL)
    b = torch.where(c > 0, table.aid_next, SENTINEL)
    a, b, c = _keep_topk_by_count(a, b, c, min(max_pairs, table.capacity))
    return CountTable(a, b, c, (c > 0).sum(dtype=I32))


def compress_pairs(
    aid: torch.Tensor, aid_next: torch.Tensor, valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unique (aid, aid_next) of a raw pair stream with their counts:
    (aid, aid_next, count, n_unique), SENTINEL-padded."""
    return seg.sort_compress(aid, aid_next, torch.ones_like(aid), valid)


# ---------------------------------------------------------------------------
# Host half: the spill store and the global merge, prune and top-N (numpy)
# ---------------------------------------------------------------------------
_KK_BITS = 23  # k2 (untagged aid) < 2^23

KMERGE_SOURCE = _build.PKG_DIR.parent / "native" / "kmerge.cc"


@functools.lru_cache(maxsize=None)
def _native_kmerge():
    """ctypes handle to `merge2_sum_i64` of native/kmerge.cc (a two-way
    merge of sorted (key, count) runs summing equal keys), built with the
    host compiler at first use; None when the source or a compiler is
    missing, and the numpy merge runs instead."""
    if not KMERGE_SOURCE.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_build.build_host(KMERGE_SOURCE)))
    except (RuntimeError, OSError) as err:
        log.warning("native kmerge unavailable, merging with numpy: %s", err)
        return None
    fn = lib.merge2_sum_i64
    p64 = ctypes.POINTER(ctypes.c_int64)
    fn.restype = ctypes.c_int64
    fn.argtypes = [p64, p64, ctypes.c_int64, p64, p64, ctypes.c_int64, p64, p64]
    return fn


def host_merge_kind() -> str:
    """Which host merge `_merge_runs_host` runs: 'c++' or 'numpy'."""
    return "c++" if _native_kmerge() is not None else "numpy"


def _merge_runs_host(runs, n_threads: Optional[int] = None):
    """[(kk sorted int64, count int64), ...] -> (kk, count) groupby-summed.
    C++: a cascade of two-way merges of size-balanced pairs (with more
    than two runs, each round's merges on a small thread pool: the ctypes
    call releases the GIL). numpy: a stable argsort of the concatenation
    (timsort, which exploits the sorted runs) and a reduceat."""
    fn = _native_kmerge()
    if fn is not None and len(runs) > 1:
        p64 = ctypes.POINTER(ctypes.c_int64)

        def m2(a, b):
            ka = np.ascontiguousarray(a[0], np.int64)
            ca = np.ascontiguousarray(a[1], np.int64)
            kb = np.ascontiguousarray(b[0], np.int64)
            cb = np.ascontiguousarray(b[1], np.int64)
            out_k = np.empty(len(ka) + len(kb), np.int64)
            out_c = np.empty(len(ka) + len(kb), np.int64)
            n = fn(
                ka.ctypes.data_as(p64), ca.ctypes.data_as(p64), len(ka),
                kb.ctypes.data_as(p64), cb.ctypes.data_as(p64), len(kb),
                out_k.ctypes.data_as(p64), out_c.ctypes.data_as(p64),
            )
            return out_k[:n], out_c[:n]

        if n_threads is None:
            import os

            n_threads = min(2, os.cpu_count() or 1)
        if n_threads > 1 and len(runs) > 2:
            from concurrent.futures import ThreadPoolExecutor

            items = sorted(runs, key=lambda r: len(r[0]))
            with ThreadPoolExecutor(n_threads) as ex:
                while len(items) > 1:
                    pairs = [(items[i], items[i + 1])
                             for i in range(0, len(items) - 1, 2)]
                    tail = [items[-1]] if len(items) % 2 else []
                    items = list(ex.map(lambda ab: m2(*ab), pairs)) + tail
                    items.sort(key=lambda r: len(r[0]))
            return items[0]

        import heapq

        # size-ordered pairing keeps the cascade balanced
        heap = [(len(r[0]), i, r) for i, r in enumerate(runs)]
        heapq.heapify(heap)
        nxt = len(runs)
        while len(heap) > 1:
            _, _, a = heapq.heappop(heap)
            _, _, b = heapq.heappop(heap)
            m = m2(a, b)
            heapq.heappush(heap, (len(m[0]), nxt, m))
            nxt += 1
        return heap[0][2]
    kk = np.concatenate([r[0] for r in runs])
    cnt = np.concatenate([r[1] for r in runs])
    order = np.argsort(kk, kind="stable")
    kk, cnt = kk[order], cnt[order]
    del order
    first = np.empty(len(kk), bool)
    first[0] = True
    np.not_equal(kk[1:], kk[:-1], out=first[1:])
    idx = np.flatnonzero(first)
    return kk[idx], np.add.reduceat(cnt, idx)


class HostRunStore:
    """Sorted tagged count runs in host memory, merged on demand.

    Once `merge_every_rows` un-merged rows accumulate, the store merges
    its runs into one (bounding peak host memory on large spills)."""

    def __init__(self, merge_every_rows: int = 256_000_000):
        self._runs: list = []          # (kk int64 sorted, count int64)
        self.rows_spilled = 0
        self.merge_every_rows = int(merge_every_rows)
        self._pending_rows = 0
        self.n_auto_merges = 0

    def add_run(self, k1: np.ndarray, k2: np.ndarray, count: np.ndarray) -> None:
        """Append one compacted run (sorted by (k1, k2), no sentinels)."""
        kk = (k1.astype(np.int64) << _KK_BITS) | k2.astype(np.int64)
        self._runs.append((kk, np.ascontiguousarray(count, np.int64)))
        self.rows_spilled += len(kk)
        self._pending_rows += len(kk)
        if self.merge_every_rows and self._pending_rows >= self.merge_every_rows:
            self._compact()
            self.n_auto_merges += 1

    def _compact(self) -> None:
        """Groupby-sum every stored run into one, in place."""
        if len(self._runs) > 1:
            runs, self._runs = self._runs, []
            kk, csum = _merge_runs_host(runs)
            del runs
            self._runs = [(kk, csum)]
        self._pending_rows = 0

    def merged(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Global groupby-sum over all runs -> (k1, k2, count) int32 sorted
        by (k1, k2); counts saturate at int32 max. The merge replaces the
        stored runs, so later add_run + merged cycles stay incremental."""
        if not self._runs:
            z = np.zeros(0, np.int32)
            return z, z.copy(), z.copy()
        self._compact()
        kk, csum = self._runs[0]
        return (
            (kk >> _KK_BITS).astype(np.int32),
            (kk & ((1 << _KK_BITS) - 1)).astype(np.int32),
            np.minimum(csum, np.iinfo(np.int32).max).astype(np.int32),
        )


def host_finalize(
    aid: np.ndarray, aid_next: np.ndarray, count: np.ndarray,
    min_count: int, max_pairs: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The global prune of one untagged count type on the host: count >=
    min_count, then the top max_pairs by count; rows stay in key order."""
    keep = count >= min_count
    aid, aid_next, count = aid[keep], aid_next[keep], count[keep]
    if len(count) > max_pairs:
        top = np.argsort(-count, kind="stable")[:max_pairs]
        top.sort()  # restore key order
        aid, aid_next, count = aid[top], aid_next[top], count[top]
    return aid, aid_next, count


def host_topn_tables(
    aid: np.ndarray, aid_next: np.ndarray, count: np.ndarray,
    n_aids: int, first_n: int,
):
    """engine.covis.build_retrieval_tables on the host, for tables past one
    device sort: five [n_aids, first_n] int32 arrays (neighbor, count,
    count_pop, perc_pop, count_rel). The population stats are computed in
    float64 here (float32 on the device)."""
    total = len(count)
    nbr = np.full((n_aids, first_n), -1, np.int32)
    cnt_t = np.zeros((n_aids, first_n), np.int32)
    cpop_t = np.zeros((n_aids, first_n), np.int32)
    ppop_t = np.zeros((n_aids, first_n), np.int32)
    crel_t = np.zeros((n_aids, first_n), np.int32)
    if total == 0:
        return nbr, cnt_t, cpop_t, ppop_t, crel_t

    order_desc = np.argsort(-count, kind="stable")
    rank_of = np.empty(total, np.int64)
    rank_of[order_desc] = np.arange(1, total + 1)
    cmin = int(count[order_desc[-1]])
    q9999 = int(count[order_desc[min(int(total * 1e-4), total - 1)]])
    denom = max(q9999 - cmin, 1)
    count_pop = (np.clip((count - cmin) / denom, None, 1.0) * 10_000).astype(np.int32)
    perc_pop = (rank_of / total * 10_000).astype(np.int32)

    # per-aid top-N by count desc
    order = np.lexsort((-count, aid))
    a_s = aid[order]
    starts = np.flatnonzero(np.concatenate([[True], a_s[1:] != a_s[:-1]]))
    start_of_row = np.repeat(starts, np.diff(np.append(starts, len(a_s))))
    rank_in_aid = np.arange(len(a_s)) - start_of_row          # 0-based
    kept = rank_in_aid < first_n
    rows = order[kept]
    a_k, r_k = a_s[kept], rank_in_aid[kept]
    max_per_aid = count[order[start_of_row[kept]]]            # rank-0 count
    nbr[a_k, r_k] = aid_next[rows]
    cnt_t[a_k, r_k] = count[rows]
    cpop_t[a_k, r_k] = count_pop[rows]
    ppop_t[a_k, r_k] = perc_pop[rows]
    crel_t[a_k, r_k] = (count[rows] / np.maximum(max_per_aid, 1) * 100).astype(np.int32)
    return nbr, cnt_t, cpop_t, ppop_t, crel_t
