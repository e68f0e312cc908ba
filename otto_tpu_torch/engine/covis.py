"""Co-visitation counting (C7) and its retrieval tables.

Counterpart of otto_tpu/engine/covis.py:

  events -> dedup -> shelf-packed length-bucketed session rows (host)
         -> one type-tagged pair stream per microbatch  (ops/pairs.py)
         -> log-structured merge ladder of sorted runs  (ops/counts.py)
         -> lossless spill of fully merged runs to host memory, pruned
            per type when large, and a global merge there (default), or a
            bounded device table pruned per type on overflow
         -> per-type global prune (finalize)
         -> dense top-N retrieval tables + features on the device

The five count types are disjoint in (type_this, type_next), so they
share one stream with the type index in the key (k1 = type * AID_STRIDE
+ aid). Raw microbatch runs are stored unsorted; every `arity` runs of a
level merge losslessly into one run of the next level, so each pair is
sorted about log_arity(C / P) times. Which pairs share a run decides what
the spill-time prune drops, so the microbatches, their order, the ladder
arity and levels are otto_tpu's for the same config.
"""
from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from otto_tpu_torch.config import CoVisConfig
from otto_tpu_torch.data.batching import (
    dedup_events,
    iter_filled_microbatches,
    pack_sessions_filled,
)
from otto_tpu_torch.data.schema import Events
from otto_tpu_torch.device import resolve
from otto_tpu_torch.ops import counts as counts_ops
from otto_tpu_torch.ops import pairs as pairs_ops
from otto_tpu_torch.ops import segment as seg
from otto_tpu_torch.ops.counts import CountTable

log = logging.getLogger(__name__)

I32 = torch.int32
F32 = torch.float32


class CoVisTables(NamedTuple):
    """Dense per-aid top-N tables for one count type, each [A, N] int32:
    neighbor (top-N aid_next by count desc, -1 pad), count (raw pair
    count), count_pop ((count - min) / (q9999 - min) clipped, x10_000),
    perc_pop (global rank / total pairs x10_000) and count_rel (count /
    max count over the aid x100). The per-aid rank is column index + 1."""

    neighbor: torch.Tensor
    count: torch.Tensor
    count_pop: torch.Tensor
    perc_pop: torch.Tensor
    count_rel: torch.Tensor


def build_retrieval_tables(table: CountTable, n_aids: int, first_n: int) -> CoVisTables:
    """A finalized sparse count table on a device -> its dense top-N tables
    there. The population stats are float32, in otto_tpu's operation order,
    so they truncate to the same ints."""
    aid, aid_next, count = table.aid, table.aid_next, table.count
    valid = (aid != seg.SENTINEL) & (count > 0)
    total = valid.sum(dtype=I32).clamp(min=1)

    cmin = torch.where(valid, count, seg.SENTINEL).min()
    c_desc = -torch.sort(torch.where(valid, -count, 0)).values
    q_idx = (total.to(F32) * 1e-4).to(I32).clamp(0, count.shape[0] - 1)
    denom = (c_desc[q_idx.long()] - cmin).clamp(min=1).to(F32)
    count_pop = (((count - cmin).to(F32) / denom).clamp(max=1.0) * 10_000).to(I32)

    # global rank by count desc, ties in row order
    global_rank = seg.ordinal_rank_desc(torch.zeros_like(aid), count, valid)
    perc_pop = (global_rank.to(F32) / total.to(F32) * 10_000).to(I32)

    # per-aid max count
    slot = torch.where(valid & (aid < n_aids), aid, n_aids).to(torch.int64)
    max_per_aid = torch.zeros(n_aids + 1, dtype=I32, device=aid.device).scatter_reduce_(
        0, slot, count, "amax")
    aid_max = max_per_aid[aid.clamp(0, n_aids).to(torch.int64)]
    count_rel = (count.to(F32) / aid_max.clamp(min=1).to(F32) * 100).to(I32)

    nbr, (cnt_t, cpop_t, ppop_t, crel_t) = seg.build_topn_tables(
        torch.where(valid, aid, seg.SENTINEL),
        aid_next,
        (count, count_pop, torch.where(valid, perc_pop, 0), count_rel),
        n_keys=n_aids,
        n_top=first_n,
        order_by=count,
    )
    return CoVisTables(nbr, cnt_t, cpop_t, ppop_t, crel_t)


def _emit_run_step(
    plan: pairs_ops.CoVisPlan,
    pad_to: int,
    aid: torch.Tensor,
    ts: torch.Tensor,
    type_: torch.Tensor,
    sess: Optional[torch.Tensor] = None,
) -> CountTable:
    """One microbatch's raw type-tagged pair run (unit counts, unsorted)."""
    k1, k2, m = pairs_ops.emit_pairs_tagged(aid, ts, type_, plan, pad_to=pad_to,
                                            sess=sess)
    return CountTable(
        aid=torch.where(m, k1, seg.SENTINEL),
        aid_next=torch.where(m, k2, seg.SENTINEL),
        count=m.to(I32),
        n=m.sum(dtype=I32),
    )


class _SpillWorker:
    """One background thread that pulls squeezed device runs to the host
    and adds them to the store, while the caller keeps feeding the device.

    Each pending run stays referenced until its pull completes; submit()
    first waits for the oldest pull once `max_pending` are in flight,
    which bounds the device memory pending runs hold. Only this worker
    touches the store between construction and join()."""

    def __init__(self, store: counts_ops.HostRunStore, max_pending: int = 2):
        self._store = store
        self._ex = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="covis-spill")
        self._pending: list = []
        self.max_pending = max_pending

    def _pull_and_add(self, run: CountTable, n: int) -> None:
        self._store.add_run(*(x[:n].cpu().numpy()
                              for x in (run.aid, run.aid_next, run.count)))

    def submit(self, run: CountTable, n: int) -> None:
        while len(self._pending) >= self.max_pending:
            self._pending.pop(0).result()  # re-raises worker errors
        self._pending.append(self._ex.submit(self._pull_and_add, run, n))

    def join(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        self.join()
        self._ex.shutdown(wait=True)


class CountLadder:
    """Log-structured merge ladder over fixed-size raw CountTable runs, on
    one device.

    Shared by CoVisCounter (tagged co-event pairs) and compute_popularity
    (tagged (kind, cluster) x aid counts): raw runs of size `run_size` are
    stored unsorted; every `arity` runs of level k merge losslessly into
    one run of level k + 1 (capacity arity^(k+1) * run_size). Runs past
    the top level spill losslessly to a host store (spill=True), first
    pruned per tag when they hold at least `prune_min_rows` rows, or fold
    into a bounded device table pruned per tag on overflow (spill=False).

    With a process `group` set (a sharded counter's data group, every rank
    pushing one run per microbatch in lockstep), the prune decision reads a
    spilled run's rows summed over the group: the rows of the same run on
    one device, so every shard prunes where the single counter does."""

    def __init__(
        self,
        run_size: int,
        top_capacity: int,
        min_in_part: Tuple[int, ...],
        stride: int,
        device,
        arity: int = 4,
        max_run_rows: int = 1 << 25,
        spill: bool = True,
        prune_min_rows: int = 0,
    ):
        self.run_size = run_size
        self.squeeze_rows = run_size   # the granularity of _squeeze
        self.group = None              # a sharded counter's data group
        self.arity = arity
        self.stride = stride
        self.device = resolve(device)
        self._min_in_part = min_in_part
        levels = 0
        while arity ** (levels + 1) * run_size <= max_run_rows:
            levels += 1
        self.n_levels = levels
        self._runs: List[List[Tuple[CountTable, bool]]] = [[] for _ in range(levels)]
        self.spill = spill
        self.prune_min_rows = prune_min_rows
        self.rows_pruned = 0
        self.n_merges = 0
        self._store = counts_ops.HostRunStore() if spill else None
        self._worker = _SpillWorker(self._store) if spill else None
        self._top_capacity = top_capacity
        self._top: Optional[CountTable] = None   # made at first use

    @property
    def rows_spilled(self) -> int:
        return self._store.rows_spilled if self.spill else 0

    def _spill_run(self, run: CountTable, compacted: bool) -> None:
        """Hand one fully merged run, compacted, pruned when large and
        squeezed, to the spill worker."""
        if not compacted:
            run = counts_ops.merge_runs_compact_raw((run,))
        if (
            self.prune_min_rows
            and any(m > 1 for m in self._min_in_part)
            and self._run_rows(run) >= self.prune_min_rows
        ):
            before = int(run.n)
            run = counts_ops.prune_tagged(run, self._min_in_part, self.stride)
            self.rows_pruned += before - int(run.n)
        run = self._squeeze(run)
        n = int(run.n)
        if n == 0:
            return
        self._worker.submit(run, n)
        log.info("covis spill: +%.1fM rows queued (%.1fM spilled so far, "
                 "%.1fM pruned)", n / 1e6, self._store.rows_spilled / 1e6,
                 self.rows_pruned / 1e6)

    def _run_rows(self, run: CountTable) -> int:
        if self.group is None:
            return int(run.n)
        n = run.n.to(torch.int64).reshape(1).clone()
        dist.all_reduce(n, group=self.group)
        return int(n)

    def _fold_top(self, run: CountTable, compacted: bool) -> None:
        self._top = counts_ops.merge_bounded_tagged(
            self.top(), self._squeeze(run) if compacted else run,
            self._min_in_part, self.stride)

    def push(self, run: CountTable) -> None:
        """Add one raw (unsorted, unit-count) run."""
        self._push(0, run)

    def push_compacted(self, run: CountTable) -> None:
        """Add one compacted run (uniques at the front, summed counts)."""
        self._push(0, run, compacted=True)

    def _push(self, level: int, run: CountTable, compacted: bool = False) -> None:
        if level >= self.n_levels:
            if self.spill:
                self._spill_run(run, compacted)
            else:
                self._fold_top(run, compacted)
            return
        self._runs[level].append((run, compacted))
        if len(self._runs[level]) == self.arity:
            entries, self._runs[level] = self._runs[level], []
            if not any(c for _, c in entries):
                merged = counts_ops.merge_runs_compact_raw([r for r, _ in entries])
            else:
                merged = counts_ops.merge_runs_compact([
                    self._squeeze(r) if c else r for r, c in entries])
            self.n_merges += 1
            self._push(level + 1, merged, compacted=True)

    def _squeeze(self, t: CountTable) -> CountTable:
        """Slice a compacted run down to the smallest power-of-two multiple
        of squeeze_rows that holds its uniques (one device sync)."""
        n = int(t.n)
        size = self.squeeze_rows
        while size < n:
            size *= 2
        if size >= t.capacity:
            return t
        return counts_ops.slice_table(t, size)

    def drain(self) -> None:
        """Fold every pending ladder run into the top table / host store."""
        for level in range(self.n_levels):
            entries, self._runs[level] = self._runs[level], []
            for run, compacted in entries:
                if self.spill:
                    self._spill_run(run, compacted)
                else:
                    self._fold_top(run, compacted)

    def top(self) -> CountTable:
        """The bounded device table (spill=False); call drain() first to
        fold in the pending runs."""
        if self._top is None:
            self._top = counts_ops.empty_table(self._top_capacity, self.device)
        return self._top

    def host_merged(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(k1, k2, count) host arrays, globally merged (spill mode)."""
        if not self.spill:
            raise RuntimeError("host_merged: the ladder does not spill")
        self.drain()
        self._worker.join()  # every pending pull lands before the merge
        return self._store.merged()

    def close(self) -> None:
        """Wait for pending pulls and stop the spill thread."""
        if self._worker is not None:
            self._worker.close()


class CoVisCounter:
    """Counts co-visitation pairs of streamed event chunks on one device.

    `capacity` is per count type (the bounded table of spill=False holds
    capacity * n_types tagged rows); `pair_budget` is the raw run size P;
    `arity` the ladder fan-in. Level-k runs hold the pairs of arity^k
    microbatches at capacity arity^k * P, so nothing is lost inside the
    ladder: only the spill-time prune (spill) or the bounded table
    (spill=False) drop pairs, both with the per-type in-part min count.
    Call close() when done, to stop the spill thread."""

    def __init__(
        self,
        cfg: CoVisConfig,
        device,
        capacity: Optional[int] = None,
        pair_budget: Optional[int] = None,
        spill: Optional[bool] = None,
        bucket_lens: Sequence[int] = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 512),
        arity: int = 4,
        max_run_rows: Optional[int] = None,
    ):
        self.cfg = cfg
        self.device = resolve(device)
        self.plan = pairs_ops.make_plan(cfg)
        if not pairs_ops.plan_types_disjoint(self.plan):
            raise ValueError(
                "count types overlap in (type_this, type_next); tagged "
                "single-stream counting requires disjoint types"
            )
        self.n_types = len(cfg.names)
        self.per_type_capacity = capacity or cfg.accumulator_capacity
        self.capacity = self.per_type_capacity * self.n_types
        self.pair_budget = pair_budget or cfg.pair_budget
        self.bucket_lens = tuple(bucket_lens)
        self.arity = arity
        self.spill = cfg.host_spill if spill is None else spill
        self._host_tables = self.spill   # tables() from _merged()'s host arrays
        self.n_microbatches = 0
        self.n_lanes = 0
        self.host_seconds = 0.0   # dedup and packing
        self._pairs = torch.zeros((), dtype=torch.int64, device=self.device)
        self.unique_pairs: Dict[str, Tuple[int, int]] = {}
        self._ladder = CountLadder(
            run_size=self.pair_budget,
            top_capacity=self.capacity,
            min_in_part=tuple(max(1, cfg.min_count_in_part.get(name, 1))
                              for name in cfg.names),
            stride=pairs_ops.AID_STRIDE,
            device=self.device,
            arity=arity,
            max_run_rows=max_run_rows or cfg.max_run_rows,
            spill=self.spill,
            prune_min_rows=cfg.spill_prune_min_rows,
        )

    @property
    def n_levels(self) -> int:
        return self._ladder.n_levels

    @property
    def ladder(self) -> CountLadder:
        return self._ladder

    @property
    def pairs_emitted(self) -> int:
        """Valid pair lanes emitted so far (one device sync)."""
        return int(self._pairs)

    def update(self, events: Events) -> None:
        """Count every co-event pair of a chunk of whole sessions. Rows are
        shelf-packed, several sessions to a row, with a lane-wise session
        id masking cross-session cells."""
        t0 = time.perf_counter()
        packed = pack_sessions_filled(dedup_events(events), self.bucket_lens)
        self.host_seconds += time.perf_counter() - t0
        for filled in packed:
            L = filled.max_len
            s_batch = pairs_ops.pair_budget_sessions(L, self.pair_budget)
            log.info("covis bucket L=%d: %d rows, %d microbatches",
                     L, filled.n_rows, -(-filled.n_rows // s_batch))
            for mb in iter_filled_microbatches(filled, s_batch):
                run = _emit_run_step(
                    self.plan, self.pair_budget,
                    *(torch.from_numpy(x).to(self.device)
                      for x in (mb.aid, mb.ts, mb.type, mb.sess)),
                )
                self.n_microbatches += 1
                self.n_lanes += mb.n_rows * L * L
                self._pairs += run.n
                self._ladder.push(run)

    @property
    def tables(self) -> Dict[str, CountTable]:
        """Per-type untagged count tables: numpy-backed, of exact occupancy,
        in spill mode; device tables of per_type_capacity rows otherwise."""
        out: Dict[str, CountTable] = {}
        stride = pairs_ops.AID_STRIDE
        if self._host_tables:
            k1, k2, cnt = self._merged()
            for i, name in enumerate(self.cfg.names):
                lo, hi = np.searchsorted(k1, [i * stride, (i + 1) * stride])
                out[name] = CountTable(
                    aid=k1[lo:hi] - np.int32(i * stride),
                    aid_next=k2[lo:hi],
                    count=cnt[lo:hi],
                    n=np.int32(hi - lo),
                )
            return out
        self._ladder.drain()
        for i, name in enumerate(self.cfg.names):
            out[name] = counts_ops.extract_tag(
                self._ladder.top(), i, stride, self.per_type_capacity)
        return out

    def _merged(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self._ladder.host_merged()

    def finalize(self) -> Dict[str, CountTable]:
        """The global prune per count type; records (unique pairs before,
        after) per type in `unique_pairs`."""
        out = {}
        for name, t in self.tables.items():
            min_c = self.cfg.min_count_to_save.get(name, 1)
            if self._host_tables:
                a, b, c = counts_ops.host_finalize(
                    t.aid, t.aid_next, t.count, min_c, self.cfg.max_pairs_to_save)
                out[name] = CountTable(a, b, c, np.int32(len(a)))
            else:
                out[name] = counts_ops.finalize(t, min_c, self.cfg.max_pairs_to_save)
            self.unique_pairs[name] = (int(t.n), int(out[name].n))
        return out

    def retrieval_tables(
        self, n_aids: int, device_topn_max_rows: int = 1 << 26
    ) -> Dict[str, CoVisTables]:
        """Finalize, then the dense top-N tables of each type on the
        counter's device. In spill mode a table of at most
        `device_topn_max_rows` rows is padded to a power of two (>= 1024)
        and built on the device; a larger one on the host."""
        final = self.finalize()
        out = {}
        for name in self.cfg.names:
            first_n = self.cfg.retrieval_first_n[name]
            t = final[name]
            if not self._host_tables:
                out[name] = build_retrieval_tables(t, n_aids, first_n)
                continue
            n = int(t.n)
            if 0 < n <= device_topn_max_rows:
                size = max(1024, 1 << (n - 1).bit_length())

                def _pad(x, fill):
                    return torch.from_numpy(np.pad(
                        np.asarray(x), (0, size - n), constant_values=fill
                    )).to(self.device)

                td = CountTable(
                    _pad(t.aid, seg.SENTINEL), _pad(t.aid_next, seg.SENTINEL),
                    _pad(t.count, 0), torch.tensor(n, dtype=I32, device=self.device),
                )
                out[name] = build_retrieval_tables(td, n_aids, first_n)
            else:
                out[name] = CoVisTables(*(
                    torch.from_numpy(a).to(self.device)
                    for a in counts_ops.host_topn_tables(
                        t.aid, t.aid_next, t.count, n_aids, first_n)
                ))
        return out

    def close(self) -> None:
        self._ladder.close()


class ShardedCoVisCounter(CoVisCounter):
    """Counting over the data ranks of a mesh (otto_tpu's
    ShardedCoVisCounter): every rank runs update() on the same events; each
    microbatch is the single counter's, its rows split over the data ranks
    (mesh.data_slice), and each rank keeps the pairs of the aids it owns
    (parallel/collectives.py).

    With cfg.host_spill (the default) each rank has its own CountLadder,
    spill worker and host run store. The microbatches, the ladder's merge
    schedule and the spill-time prune (on a run's rows summed over the
    ranks) are the single counter's, so each rank's store holds exactly the
    single counter's rows of its aids.

    With host_spill=False, otto_tpu's bounded form: each rank merges its
    owned pairs of every microbatch into its shard of the tagged table
    (make_sharded_covis_update; `capacity_per_shard` rows, default
    max(2^16, ceil(capacity / n_data))), and the shards are gathered
    (gather_tagged_table). The single counter's bounded table prunes when
    it overflows, a choice over every key that the shards cannot repeat;
    so when the single table would have pruned (the shards' rows together
    past its capacity, or one type's past per_type_capacity) or a shard
    filled up, `tables` raises ValueError rather than return other tables.

    Either way the tables are built on every rank from replicated data:
    `tables` gathers every rank's rows to every rank, and the global prune
    (finalize) and the retrieval tables then run there as on one device.
    Call close() when done."""

    def __init__(self, cfg: CoVisConfig, mesh, capacity_per_shard: Optional[int] = None,
                 **kw):
        from otto_tpu_torch.parallel.collectives import (
            make_sharded_covis_update,
            make_sharded_table,
        )

        super().__init__(cfg, mesh.device, **kw)
        self.mesh = mesh
        self._host_tables = True
        if self.spill:
            self._ladder.group = mesh.data_group
            # a rank's runs hold its owned share of a microbatch's pairs,
            # often far below the pair budget: slice them to their content
            self._ladder.squeeze_rows = 1 << 12
        else:
            self.capacity_per_shard = capacity_per_shard or max(
                1 << 16, -(-self.capacity // mesh.n_data))
            self._update_shard = make_sharded_covis_update(self.plan, mesh)
            self._shard = make_sharded_table(self.capacity_per_shard, mesh)

    def update(self, events: Events) -> None:
        from otto_tpu_torch.parallel.collectives import sharded_pair_run

        t0 = time.perf_counter()
        packed = pack_sessions_filled(dedup_events(events), self.bucket_lens)
        self.host_seconds += time.perf_counter() - t0
        for filled in packed:
            L = filled.max_len
            s_batch = pairs_ops.pair_budget_sessions(L, self.pair_budget)
            for mb in iter_filled_microbatches(filled, s_batch):
                cols = [torch.from_numpy(x).to(self.device)
                        for x in (mb.aid, mb.ts, mb.type, mb.sess)]
                if self.spill:
                    run, n_pairs = sharded_pair_run(self.plan, self.mesh, *cols)
                    self._ladder.push_compacted(run)
                else:
                    self._shard, n_pairs = self._update_shard(self._shard, *cols)
                self.n_microbatches += 1
                sl = self.mesh.data_slice(mb.n_rows)
                self.n_lanes += (sl.stop - sl.start) * L * L
                self._pairs += n_pairs

    def _merged(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        from otto_tpu_torch.parallel.collectives import gather_owned

        return gather_owned(self.mesh, *self._ladder.host_merged())

    @property
    def tables(self) -> Dict[str, CountTable]:
        """Per-type untagged count tables, numpy-backed, of exact occupancy,
        gathered from every rank (ValueError where the bounded table of one
        device would have pruned)."""
        from otto_tpu_torch.parallel.collectives import gather_tagged_table

        if self.spill:
            return super().tables
        full = torch.tensor([int(self._shard.n) >= self.capacity_per_shard],
                            dtype=torch.int64, device=self.device)
        self.mesh.all_max(full)
        by_type = gather_tagged_table(self._shard, self.cfg.names, self.mesh)
        rows = {name: len(t[0]) for name, t in by_type.items()}
        if int(full) or sum(rows.values()) > self.capacity or max(
                rows.values()) > self.per_type_capacity:
            raise ValueError(
                f"sharded bounded co-visitation table: rows by type {rows}, a shard "
                f"{'full' if int(full) else 'within'} its {self.capacity_per_shard} rows; "
                f"one device's bounded table ({self.capacity} rows, "
                f"{self.per_type_capacity} a type) would have pruned, and the shards do "
                "not prune as it does: raise accumulator_capacity or use host_spill=True")
        return {name: CountTable(a, b, c, np.int32(len(a)))
                for name, (a, b, c) in by_type.items()}


def count_events(
    events: Events,
    cfg: CoVisConfig,
    device,
    capacity: Optional[int] = None,
    min_count_override: Optional[int] = None,
) -> Dict[str, CountTable]:
    """One-shot counting of a whole event table -> finalized per-type
    tables (with `min_count_override`, that min count for every type)."""
    counter = CoVisCounter(cfg, device, capacity=capacity)
    try:
        counter.update(events)
        if min_count_override is None:
            return counter.finalize()
        return {
            name: counts_ops.finalize(
                CountTable(*(torch.as_tensor(x, device=counter.device) for x in t)),
                min_count_override, cfg.max_pairs_to_save)
            for name, t in counter.tables.items()
        }
    finally:
        counter.close()
