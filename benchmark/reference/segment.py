"""Frozen copy of `otto_tpu_torch/ops/segment.py` at commit 7f160d3 (the
benchmark's plain reference: the sorted-layout groupbys, with kernels K1 and K2 replaced by their plain twins). It imports nothing of
otto_tpu_torch, so later changes to the port cannot move the yardstick;
benchmark/tests/test_bench_frozen.py holds its output equal to the
port's at a tiny size.

The original docstring follows.

Sort-based segment (groupby) primitives.

Counterpart of otto_tpu/ops/segment.py, in two halves:

- flat (1-D) groupbys over composite int32 keys, for co-visitation and
  popularity counting: `sort_compress*`, `sort_by_keys`,
  `segment_starts`, `ordinal_rank_*`, `build_topn_tables`;
- row-wise (per-session) primitives over padded [S, C] tensors: every
  per-session groupby, window rank and dedup of retrieval is a stable
  sort along the last axis plus a segmented scan.

Invalid lanes carry the SENTINEL key (int32 max) and so sort last; ties
keep their input order wherever otto_tpu's sort is stable. Public
functions keep the int32 layout of the reference; indices are cast to
int64 only where torch's indexing needs it.

`torch.sort` takes one key: a lexicographic (k1, k2) sort of int32 keys
sorts one int64 key `k1 * 2^32 + (k2 + 2^31)`, exact for every int32
pair. The flat segmented sums are int64 cumsums minus the prefix at each
segment start, cast back to int32: the sum mod 2^32, as otto_tpu's
wrapping int32 scan network gives it. Segment ends are compacted to the
front by their rank among the ends (a scatter to unique slots), not by a
second sort: the ends already lie in key order.

The column moves of `rowwise_transport_sort` go through kernel K1
(ops/kernels/gather.py) and the scans of `rowwise_groupby_scan` through
kernel K2 (ops/kernels/segscan.py). The flat half runs no kernel of its
own: otto_tpu runs those scans as an XLA network, not a Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from benchmark.reference.twins import MAX_COLS
from benchmark.reference.twins import gather_rows_ref as gather_rows
from benchmark.reference.twins import identity as _reduce_identity
from benchmark.reference.twins import segmented_scan_ref as segmented_scan

SENTINEL = 2**31 - 1
NEG_SENTINEL = -(2**31 - 1)


def _prev(x: torch.Tensor, fill) -> torch.Tensor:
    """x[..., i-1] with x[..., 0] := fill."""
    return torch.cat([torch.full_like(x[..., :1], fill), x[..., :-1]], dim=-1)


def _next(x: torch.Tensor, fill) -> torch.Tensor:
    """x[..., i+1] with x[..., -1] := fill."""
    return torch.cat([x[..., 1:], torch.full_like(x[..., :1], fill)], dim=-1)


def _argsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """int64 permutation of a stable lexicographic sort along the last axis
    (first key most significant): stable sorts from the last key up."""
    perm = None
    for k in reversed(keys):
        kk = k if perm is None else torch.gather(k, -1, perm)
        _, p = torch.sort(kk, dim=-1, stable=True)
        perm = p if perm is None else torch.gather(perm, -1, p)
    return perm


# ---------------------------------------------------------------------------
# Flat (1-D) groupby over composite int32 keys
# ---------------------------------------------------------------------------
_LO = 2**31


def _key64(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """One int64 key that orders int32 (k1, k2) pairs lexicographically."""
    return k1.to(torch.int64) * (1 << 32) + (k2.to(torch.int64) + _LO)


# _key64 of (NEG_SENTINEL, NEG_SENTINEL): the "previous key" of row 0
_NEG_KEY = NEG_SENTINEL * (1 << 32) + (NEG_SENTINEL + _LO)


def _split64(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return (key >> 32).to(torch.int32), ((key & 0xFFFFFFFF) - _LO).to(torch.int32)


def _sort_pairs(k1, k2):
    """(k1 sorted, k2 sorted, first-of-segment flags, int64 permutation);
    the order of equal keys is unspecified (lax.sort without is_stable)."""
    key, perm = torch.sort(_key64(k1, k2))
    k1s, k2s = _split64(key)
    return k1s, k2s, key != _prev(key, _NEG_KEY), perm


def _segment_start_index(first: torch.Tensor) -> torch.Tensor:
    """For each row, the index (int64) where its segment starts: the last
    row at or before it with `first` set, 0 when there is none (otto_tpu's
    cummax of where(first, pos, 0)). Computed as the k-th start's position,
    k the count of starts so far: a cumsum, a scatter and a gather, not
    torch.cummax, whose CUDA scan with indices is ~100x slower."""
    n = first.shape[0]
    k = torch.cumsum(first, 0)
    start_of = torch.zeros(n + 2, dtype=torch.int64, device=first.device)
    start_of.scatter_(0, torch.where(first, k, n + 1),
                      torch.arange(n, device=first.device))
    return start_of[k]


def _segment_sums(first: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum of int32 v: the last row of every segment
    holds the segment's total, mod 2^32."""
    if v.dtype != torch.int32:
        raise TypeError(f"flat segmented sums are int32, got {v.dtype}")
    cs = torch.cumsum(v.to(torch.int64), 0)
    excl = cs - v
    return (cs - excl[_segment_start_index(first)]).to(torch.int32)


def _compact(is_end: torch.Tensor, cols, fills) -> List[torch.Tensor]:
    """The rows where is_end holds, moved to the front in order; the other
    rows carry `fill`. Slot n takes every other row and is dropped."""
    n = is_end.shape[0]
    dest = torch.where(is_end, torch.cumsum(is_end, 0) - 1, n)
    out = []
    for c, fill in zip(cols, fills):
        o = torch.full((n + 1,), fill, dtype=c.dtype, device=c.device)
        o.scatter_(0, dest, c)
        out.append(o[:n])
    return out


def _mask_invalid(k1, k2, values, valid):
    if valid is None:
        return k1, k2, values
    return (torch.where(valid, k1, SENTINEL), torch.where(valid, k2, SENTINEL),
            tuple(torch.where(valid, v, 0) for v in values))


def sort_compress(
    k1: torch.Tensor,
    k2: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Groupby (k1, k2) -> sum(v), all int32 [N].

    Returns (uk1, uk2, uv, n_unique): unique keys packed at the front in
    ascending (k1, k2) order; padding rows carry SENTINEL keys and uv 0;
    n_unique is a 0-d int32 tensor on the keys' device."""
    uk1, uk2, (uv,), n = sort_compress_multi(k1, k2, (v,), valid)
    return uk1, uk2, uv, n


def sort_compress_ends(
    k1: torch.Tensor, k2: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """sort_compress without the front compaction: unique keys stay at
    their segment-END rows of the sorted order (other rows SENTINEL / 0)."""
    k1s, k2s, first, perm = _sort_pairs(k1, k2)
    a = _segment_sums(first, v[perm])
    is_end = _next(first, True) & (k1s != SENTINEL)
    return (torch.where(is_end, k1s, SENTINEL), torch.where(is_end, k2s, SENTINEL),
            torch.where(is_end, a, 0), is_end.sum(dtype=torch.int32))


def sort_compress_multi(
    k1: torch.Tensor,
    k2: torch.Tensor,
    values: Sequence[torch.Tensor],
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...], torch.Tensor]:
    """Groupby (k1, k2) -> sum of each int32 value column."""
    k1, k2, values = _mask_invalid(k1, k2, tuple(values), valid)
    k1s, k2s, first, perm = _sort_pairs(k1, k2)
    sums = [_segment_sums(first, v[perm]) for v in values]
    is_end = _next(first, True) & (k1s != SENTINEL)
    uk1, uk2, *uvs = _compact(is_end, [k1s, k2s, *sums],
                              [SENTINEL, SENTINEL] + [0] * len(sums))
    return uk1, uk2, tuple(uvs), is_end.sum(dtype=torch.int32)


def sort_by_keys(
    keys: Sequence[torch.Tensor], values: Sequence[torch.Tensor]
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Stable lexicographic sort of `values` by `keys` (ascending)."""
    return rowwise_sort(keys, values)


def segment_starts(seg_sorted: torch.Tensor) -> torch.Tensor:
    """For each element of a sorted segment-id array, the index (int32)
    where its segment starts."""
    first = seg_sorted != _prev(seg_sorted, NEG_SENTINEL)
    return _segment_start_index(first).to(torch.int32)


def ordinal_rank_desc(
    group: torch.Tensor,
    value: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """1-based ordinal rank of `value` (descending) within each `group`,
    ties broken by original order; invalid lanes get rank SENTINEL."""
    n = group.shape[0]
    if valid is not None:
        group = torch.where(valid, group, SENTINEL)
    _, perm = torch.sort(_key64(group, -value.to(torch.int32)), stable=True)
    pos = torch.arange(n, dtype=torch.int32, device=group.device)
    rank_sorted = pos - segment_starts(group[perm]) + 1
    rank = torch.empty_like(rank_sorted).scatter_(0, perm, rank_sorted)
    if valid is not None:
        rank = torch.where(valid, rank, SENTINEL)
    return rank


def ordinal_rank_asc(
    group: torch.Tensor,
    value: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """1-based ascending ordinal rank within group."""
    return ordinal_rank_desc(group, -value.to(torch.int32), valid)


def build_topn_tables(
    key: torch.Tensor,
    neighbor: torch.Tensor,
    values: Sequence[torch.Tensor],
    n_keys: int,
    n_top: int,
    order_by: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Scatter a sparse (key, neighbor, *values) relation into dense
    [n_keys, n_top] tables ordered by `order_by` desc (default values[0]);
    rows past n_top and SENTINEL or out-of-range keys are dropped.
    -> (neighbor table int32 (-1 pad), value tables (0 pad))."""
    order = order_by if order_by is not None else values[0]
    valid = key != SENTINEL
    slot = ordinal_rank_desc(key, order, valid) - 1
    keep = valid & (key >= 0) & (key < n_keys) & (slot < n_top)
    size = n_keys * n_top
    # (key, slot) pairs are unique: every kept row has a slot of its own
    flat = torch.where(keep, key.to(torch.int64) * n_top + slot, size)

    def table(v, fill):
        t = torch.full((size + 1,), fill, dtype=v.dtype, device=v.device)
        t.index_put_((flat,), v)
        return t[:size].view(n_keys, n_top)

    return table(neighbor, -1), tuple(table(v, 0) for v in values)


def rowwise_sort(
    keys: Sequence[torch.Tensor], values: Sequence[torch.Tensor] = ()
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Stable sort along the last axis by lexicographic keys."""
    perm = _argsort(keys)
    return (
        [torch.gather(k, -1, perm) for k in keys],
        [torch.gather(v, -1, perm) for v in values],
    )


def rowwise_transport_sort(
    key: torch.Tensor, arrays: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Stable-sort `arrays` by `key` [S, C] along the last axis: one key
    sort, then every column moves through the permutation in one K1 gather
    per dtype (per MAX_COLS columns), which reads the columns where they
    lie. Returns (sorted_key, [sorted_arrays...])."""
    ks, perm = torch.sort(key, dim=-1, stable=True)
    if not arrays:
        return ks, []
    perm32 = perm.to(torch.int32)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, a in enumerate(arrays):
        groups.setdefault(a.dtype, []).append(i)
    outs: List[torch.Tensor] = [None] * len(arrays)
    for idxs in groups.values():
        for c0 in range(0, len(idxs), MAX_COLS):
            part = idxs[c0:c0 + MAX_COLS]
            g = gather_rows([arrays[i] for i in part], perm32)
            for j, i in enumerate(part):
                outs[i] = g[j]
    return ks, outs


def rowwise_groupby_scan(
    key: torch.Tensor, columns: dict
) -> Tuple[torch.Tensor, dict, torch.Tensor, torch.Tensor]:
    """Sorted-layout per-row groupby: transport-sort by key, then segmented-
    scan each column so the LAST lane of every segment holds the segment's
    reduction.

    `columns` maps name -> (array [S, C], reducer), reducer in
    {'sum', 'min', 'max', 'carry'}; 'carry' columns are segment-constant
    and ride the sort without a scan.

    Returns (ks sorted keys, {name: scanned}, is_end segment-end marks
    (False on SENTINEL lanes), n_unique [S] int32)."""
    names = list(columns)
    ks, sorted_cols = rowwise_transport_sort(
        key, [columns[n][0] for n in names]
    )
    by_name = dict(zip(names, sorted_cols))
    first = ks != _prev(ks, NEG_SENTINEL)
    valid_key = ks != SENTINEL

    # one stacked K2 launch per (dtype, reducer)
    groups: dict = {}
    for n in names:
        arr, red = columns[n]
        if red != "carry":
            groups.setdefault((arr.dtype, red), []).append(n)
    out = dict(by_name)
    for (_, red), gnames in groups.items():
        sc = segmented_scan(torch.stack([by_name[n] for n in gnames]), first, red)
        for j, n in enumerate(gnames):
            out[n] = sc[j]

    is_end = _next(first, True) & valid_key
    n_unique = (first & valid_key).sum(dim=-1, dtype=torch.int32)
    return ks, out, is_end, n_unique


def rowwise_groupby(
    key: torch.Tensor, columns: dict
) -> Tuple[torch.Tensor, dict, torch.Tensor]:
    """Per-row groupby: rowwise_groupby_scan, then a second transport sort
    keyed on "segment end ? key : SENTINEL" compacts each segment's total
    to the front in ascending-key order.

    Returns (unique_key [S, C] SENTINEL back-padded, {name: reduced [S, C]},
    n_unique [S]). Padding lanes carry each reducer's identity."""
    names = list(columns)
    ks, scanned, is_end, n_unique = rowwise_groupby_scan(key, columns)
    comp_key = torch.where(is_end, ks, SENTINEL)
    uk, comp = rowwise_transport_sort(comp_key, [scanned[n] for n in names])
    is_pad_slot = uk == SENTINEL
    out = {}
    for i, n in enumerate(names):
        ident = _reduce_identity(columns[n][0].dtype, columns[n][1])
        out[n] = torch.where(is_pad_slot, ident, comp[i])
    return uk, out, n_unique


def rowwise_unique_sum(
    key: torch.Tensor, values: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...], torch.Tensor]:
    """Per row: groupby key -> sum(values). Keys carry SENTINEL on invalid
    lanes. -> (unique keys [S, C] SENTINEL back-padded, sums, n_unique)."""
    return rowwise_segment_reduce(key, values, ("sum",) * len(values))


def rowwise_segment_reduce(
    key: torch.Tensor,
    values: Sequence[torch.Tensor],
    reducers: Sequence[str],
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...], torch.Tensor]:
    """Per-row groupby with mixed reducers ('sum' | 'max' | 'min' |
    'count', the last a sum of the given column)."""
    if len(values) != len(reducers):
        raise ValueError("rowwise_segment_reduce: one reducer per column")
    cols = {f"v{i}": (v, "sum" if r == "count" else r)
            for i, (v, r) in enumerate(zip(values, reducers))}
    uk, out, n_unique = rowwise_groupby(key, cols)
    return uk, tuple(out[f"v{i}"] for i in range(len(values))), n_unique


def rowwise_rank_desc(value: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """1-based ordinal rank (descending) along the last axis, ties by
    position; invalid lanes -> SENTINEL. The vectorized
    `rank('ordinal', reverse=True).over('session')`."""
    neg_v = torch.where(valid, -value.to(torch.int32), SENTINEL)
    _, perm = torch.sort(neg_v, dim=-1, stable=True)
    C = value.shape[-1]
    ranks = torch.arange(1, C + 1, dtype=torch.int32, device=value.device)
    rank = torch.empty_like(neg_v).scatter_(-1, perm, ranks.expand_as(neg_v))
    return torch.where(valid, rank, SENTINEL)


def rowwise_rank_asc(value: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return rowwise_rank_desc(torch.where(valid, -value, value), valid)
