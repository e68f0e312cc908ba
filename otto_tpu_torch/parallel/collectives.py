"""Sharded co-visitation counting: all-to-all count exchange.

Counterpart of otto_tpu/parallel/collectives.py. Every data rank emits the
type-tagged pairs of its share of a microbatch's rows, combines them
locally (sort_compress), and one all-to-all routes each compressed
(key, aid_next, count) triple to the rank that owns its key: rank
(k1 % AID_STRIDE) % n owns every count type's row of an aid. The owner
combines what it received; shards own disjoint keys, so the global table
is the concatenation of theirs.

The send buffers are fixed [n, E] blocks (E = the emission length, padded
with SENTINEL keys and zero counts), so no split sizes cross the host; the
three columns travel stacked in one all_to_all_single.

engine/covis.py::ShardedCoVisCounter takes a rank's compacted runs from
`sharded_pair_run` into its ladder when it spills to the host (the
default), and keeps otto_tpu's bounded table (`make_sharded_table`,
`make_sharded_covis_update`, `gather_tagged_table`) with host_spill=False.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from otto_tpu_torch.ops import counts as counts_ops
from otto_tpu_torch.ops import pairs as pairs_ops
from otto_tpu_torch.ops import segment as seg
from otto_tpu_torch.ops.counts import CountTable
from otto_tpu_torch.ops.pairs import AID_STRIDE
from otto_tpu_torch.parallel.mesh import MeshContext

SENT = seg.SENTINEL
I32 = torch.int32


def _exchange_by_owner(ua, ub, uc, n_shards: int, group):
    """Route compressed triples [E] (SENTINEL padded) to their owner shard
    ((k1 % AID_STRIDE) % n_shards) -> the [n_shards * E] triples this shard
    owns, SENTINEL / 0 padded."""
    E = ua.shape[0]
    dev = ua.device
    valid = (ua != SENT) & (uc > 0)
    owner = torch.where(valid, (ua % AID_STRIDE) % n_shards, n_shards).to(torch.int64)
    order = torch.sort(owner, stable=True).indices
    owner_s = owner[order]
    # slot within the owner's block: position minus the block's start
    starts = torch.searchsorted(owner_s, owner_s, right=False)
    slot = torch.arange(E, device=dev) - starts
    keep = owner_s < n_shards
    send = torch.full((n_shards * E, 3), 0, dtype=I32, device=dev)
    send[:, :2] = SENT
    dst = (owner_s * E + slot)[keep]
    send[dst] = torch.stack([ua, ub, uc], dim=1)[order][keep]
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv[:, 0], recv[:, 1], recv[:, 2]


def sharded_pair_run(plan: pairs_ops.CoVisPlan, mesh: MeshContext, aid, ts, type_,
                     sess=None) -> Tuple[CountTable, torch.Tensor]:
    """One microbatch [S, L] (the same rows on every data rank) -> (this
    rank's compacted run of the pairs it owns, the pairs its rows emitted):
    it emits the pairs of its data_slice of the rows, padded to
    ceil(S / n) * L * L lanes so that every rank's buffers match,
    exchanges them and combines."""
    n = mesh.n_data
    S, L = aid.shape
    sl = mesh.data_slice(S)
    k1, k2, m = pairs_ops.emit_pairs_tagged(
        aid[sl], ts[sl], type_[sl], plan, pad_to=-(-S // n) * L * L,
        sess=None if sess is None else sess[sl])
    ua, ub, uc, _ = seg.sort_compress(k1, k2, m.to(I32))
    ra, rb, rc = _exchange_by_owner(ua, ub, uc, n, mesh.data_group)
    return CountTable(*seg.sort_compress(ra, rb, rc)), m.sum(dtype=I32)


def make_sharded_covis_update(plan: pairs_ops.CoVisPlan, mesh: MeshContext
                              ) -> Callable[..., Tuple[CountTable, torch.Tensor]]:
    """-> update(table, aid, ts, type, sess) -> (this rank's bounded
    CountTable (make_sharded_table) with the microbatch's owned pairs merged
    in (merge_into: on overflow the smallest counts go), the pairs its rows
    emitted). Every data rank calls it with the same microbatch."""
    if not pairs_ops.plan_types_disjoint(plan):
        raise ValueError("tagged sharded counting requires disjoint count types")

    def update(table: CountTable, aid, ts, type_, sess=None):
        run, n_pairs = sharded_pair_run(plan, mesh, aid, ts, type_, sess)
        return counts_ops.merge_into(table, run.aid, run.aid_next, run.count), n_pairs

    return update


def make_sharded_table(capacity_per_shard: int, mesh: MeshContext) -> CountTable:
    """This rank's empty shard of the tagged count table: it owns the keys
    with (k1 % AID_STRIDE) % n_data == data_rank."""
    return counts_ops.empty_table(capacity_per_shard, mesh.device)


def gather_owned(mesh: MeshContext, k1, k2, count) -> Tuple[np.ndarray, ...]:
    """Every shard's owned rows (host or device arrays, any count) -> the
    global table on every rank, sorted by (k1, k2): shards own disjoint keys,
    so concatenating and sorting merges them."""
    a, b, c = mesh.gather_arrays(k1, k2, count)
    # the shards' sorted runs, merged by a stable sort of the 64-bit keys
    order = np.argsort((a.astype(np.int64) << 32) | b.astype(np.int64), kind="stable")
    return a[order], b[order], c[order]


def gather_tagged_table(table: CountTable, names, mesh: MeshContext
                        ) -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Every shard's valid rows, gathered, split by type tag -> {count type:
    (aid, aid_next, count)} sorted by key, on every rank."""
    valid = (table.aid != SENT) & (table.count > 0)
    a, b, c = gather_owned(mesh, table.aid[valid], table.aid_next[valid],
                           table.count[valid])
    tag = a // AID_STRIDE
    return {name: (a[tag == i] - i * AID_STRIDE, b[tag == i], c[tag == i])
            for i, name in enumerate(names)}
