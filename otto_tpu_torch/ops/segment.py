"""Row-wise (per-session) segment primitives over padded [S, C] tensors.

Counterpart of the row-wise half of otto_tpu/ops/segment.py: every per-
session groupby, window rank and dedup of retrieval is a stable sort along
the last axis plus a segmented scan. Invalid lanes carry the SENTINEL key
(int32 max) and so sort last; ties keep their input order (every sort is
`torch.sort(..., stable=True)`). Public functions keep the int32 layout of
the reference; indices are cast to int64 only where `torch.gather` needs it.

The column moves of `rowwise_transport_sort` go through kernel K1
(ops/kernels/gather.py) and the scans of `rowwise_groupby_scan` through
kernel K2 (ops/kernels/segscan.py).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from otto_tpu_torch.ops.kernels.gather import gather_rows
from otto_tpu_torch.ops.kernels.segscan import identity as _reduce_identity
from otto_tpu_torch.ops.kernels.segscan import segmented_scan

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
    per dtype. Returns (sorted_key, [sorted_arrays...])."""
    ks, perm = torch.sort(key, dim=-1, stable=True)
    if not arrays:
        return ks, []
    perm32 = perm.to(torch.int32)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, a in enumerate(arrays):
        groups.setdefault(a.dtype, []).append(i)
    outs: List[torch.Tensor] = [None] * len(arrays)
    for idxs in groups.values():
        g = gather_rows(torch.stack([arrays[i] for i in idxs]), perm32)
        for j, i in enumerate(idxs):
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
