"""Co-visitation counting: otto_tpu_torch against otto_tpu, bit for bit.

The same numpy events go through otto_tpu's CoVisCounter and the port's
(on the CPU) in three modes: spill with the spill-time prune running,
lossless spill, and the bounded device table overflowing into its per-type
prune. The per-type count tables, the counter's stats and all five fields
of all five retrieval tables must be equal, on the device top-N path and
on the host one. The ops underneath (pair emission, the merges, prune,
extract, finalize, the host store and top-N) are held to otto_tpu's on
small hand-made and random inputs, and the C++ host merge to the numpy
one. Tiny shapes and bucket_lens=(8, 32), as tests/test_covis.py uses.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.config import CoVisConfig as RefCoVisConfig
from otto_tpu.data.synthetic import SyntheticSpec, generate
from otto_tpu.engine import covis as ref_covis
from otto_tpu.ops import counts as ref_counts
from otto_tpu.ops import pairs as ref_pairs
from otto_tpu_torch.config import CoVisConfig
from otto_tpu_torch.data.schema import Events
from otto_tpu_torch.engine import covis as port_covis
from otto_tpu_torch.ops import counts as port_counts
from otto_tpu_torch.ops import pairs as port_pairs
from test_covis import oracle_counts, table_to_dict
import torch_threads  # noqa: F401

SENT = port_counts.SENTINEL
N_AIDS = 500

# (otto_tpu config overrides, counter kwargs) per mode
MODES = {
    # every spilled run pruned: runs merge in a ladder, spill, prune, merge
    "spill_pruned": (dict(spill_prune_min_rows=1),
                     dict(pair_budget=1 << 12, max_run_rows=1 << 14, spill=True)),
    "spill": (dict(), dict(pair_budget=1 << 12, max_run_rows=1 << 14, spill=True)),
    # 256 pairs per type: the bounded table overflows and prunes
    "device": (dict(), dict(capacity=256, pair_budget=1 << 12, spill=False)),
}


def _events(n_sessions=400, seed=13, max_len=40):
    ev = generate(SyntheticSpec(n_sessions=n_sessions, n_aids=N_AIDS, max_len=max_len,
                                mean_len=10, seed=seed))
    return ev, Events(ev.session, ev.aid, ev.ts, ev.type)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tables_equal(got, want):
    for f in ref_counts.CountTable._fields:
        g, w = _np(getattr(got, f)), _np(getattr(want, f))
        np.testing.assert_array_equal(g, w, err_msg=f)
        assert g.dtype == w.dtype, f


@functools.lru_cache(maxsize=None)
def counted(mode):
    """Both counters after update(first half), update(second half)."""
    over, kw = MODES[mode]
    ref_ev, ev = _events()
    mid = ref_ev.session < 200
    ref = ref_covis.CoVisCounter(dataclasses.replace(RefCoVisConfig(), **over),
                                 bucket_lens=(8, 32), **kw)
    port = port_covis.CoVisCounter(dataclasses.replace(CoVisConfig(), **over), "cpu",
                                   bucket_lens=(8, 32), **kw)
    for m in (mid, ~mid):
        ref.update(ref_ev.select(m))
        port.update(ev.select(m))
    out = {"ref": ref, "port": port, "ref_tables": ref.tables, "port_tables": port.tables,
           "ref_rt": ref.retrieval_tables(N_AIDS), "port_rt": port.retrieval_tables(N_AIDS)}
    port.close()
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_count_tables_equal(mode):
    c = counted(mode)
    for name in RefCoVisConfig().names:
        _assert_tables_equal(c["port_tables"][name], c["ref_tables"][name])


@pytest.mark.parametrize("mode", list(MODES))
def test_counter_stats_equal(mode):
    c = counted(mode)
    ref, port = c["ref"], c["port"]
    assert port.n_levels == ref.n_levels
    assert port.ladder.rows_pruned == ref._ladder.rows_pruned
    if port.spill:
        assert port.ladder.rows_spilled == ref._store.rows_spilled > 0
    if mode == "spill_pruned":
        assert port.ladder.rows_pruned > 0
    assert port.n_microbatches > 0 and port.pairs_emitted > 0
    assert set(port.unique_pairs) == set(RefCoVisConfig().names)


@pytest.mark.parametrize("mode", list(MODES))
def test_retrieval_tables_equal(mode):
    c = counted(mode)
    for name in RefCoVisConfig().names:
        for f, got, want in zip(port_covis.CoVisTables._fields, c["port_rt"][name],
                                c["ref_rt"][name]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{name}.{f}")
            assert got.dtype == torch.int32
    assert sum(int((t.neighbor[:, 0] >= 0).sum()) for t in c["port_rt"].values()) > 0


def test_host_topn_path_equal():
    """Spill mode with the device top-N turned off builds on the host."""
    ref_ev, ev = _events(300, seed=9)
    kw = dict(pair_budget=1 << 12, bucket_lens=(8, 32), spill=True)
    ref = ref_covis.CoVisCounter(RefCoVisConfig(), **kw)
    ref.update(ref_ev)
    port = port_covis.CoVisCounter(CoVisConfig(), "cpu", **kw)
    port.update(ev)
    want = ref.retrieval_tables(N_AIDS, device_topn_max_rows=0)
    got = port.retrieval_tables(N_AIDS, device_topn_max_rows=0)
    dev = port.retrieval_tables(N_AIDS)
    port.close()
    for name in RefCoVisConfig().names:
        for f, g, w, d in zip(port_covis.CoVisTables._fields, got[name], want[name], dev[name]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{name}.{f}")
            np.testing.assert_array_equal(g.numpy(), d.numpy(), err_msg=f"{name}.{f}")


def test_counter_matches_oracle():
    # sessions within the largest bucket: none is cut to its last events
    ref_ev, ev = _events(300, seed=3, max_len=32)
    counter = port_covis.CoVisCounter(CoVisConfig(), "cpu", capacity=1 << 15,
                                      pair_budget=1 << 14, bucket_lens=(8, 32),
                                      spill=False)
    counter.update(ev)
    want = oracle_counts(ref_ev, RefCoVisConfig())
    for name, t in counter.tables.items():
        assert table_to_dict(port_counts.finalize(t, 1, 10**9)) == want[name], name


def test_count_events_matches_reference():
    ref_ev, ev = _events(150, seed=5)
    cfg = dataclasses.replace(CoVisConfig(), pair_budget=1 << 12)
    ref_cfg = dataclasses.replace(RefCoVisConfig(), pair_budget=1 << 12)
    for override in (None, 1):
        got = port_covis.count_events(ev, cfg, "cpu", min_count_override=override)
        want = ref_covis.count_events(ref_ev, ref_cfg, min_count_override=override)
        for name in cfg.names:
            _assert_tables_equal(got[name], want[name])


def test_counter_refuses_overlapping_types():
    cfg = dataclasses.replace(CoVisConfig(), count_types={
        "a": (0, (0, 1)), "b": (0, (1,))},
        max_time_to_next_by_type={"a": 10, "b": 10})
    with pytest.raises(ValueError):
        port_covis.CoVisCounter(cfg, "cpu")


# ---------------------------------------------------------------------------
# pairs
# ---------------------------------------------------------------------------
def _grid(seed, S=6, L=12):
    rng = np.random.default_rng(seed)
    aid = rng.integers(0, 30, (S, L)).astype(np.int32)
    aid[rng.random((S, L)) < 0.2] = -1
    ts = np.sort(rng.integers(0, 3 * 86400, (S, L)), axis=1).astype(np.int32)
    typ = rng.integers(0, 3, (S, L)).astype(np.int32)
    sess = np.repeat(np.arange(S * 3, dtype=np.int32).reshape(S, 3), L // 3, axis=1)
    return aid, ts, typ, sess


def test_plan_matches_reference():
    assert port_pairs.make_plan(CoVisConfig()) == ref_pairs.make_plan(RefCoVisConfig())
    assert port_pairs.AID_STRIDE == ref_pairs.AID_STRIDE
    plan = port_pairs.make_plan(CoVisConfig())
    assert port_pairs.plan_types_disjoint(plan)
    overlapping = plan._replace(types=plan.types + (plan.types[0],))
    assert not port_pairs.plan_types_disjoint(overlapping)
    for L in (1, 8, 24, 512, 3000):
        assert port_pairs.pair_budget_sessions(L, 1 << 14) == \
            ref_pairs.pair_budget_sessions(L, 1 << 14)


@pytest.mark.parametrize("seed", [0, 1])
def test_emit_pairs_matches_reference(seed):
    aid, ts, typ, _ = _grid(seed)
    plan = ref_pairs.make_plan(RefCoVisConfig())
    want = ref_pairs.emit_pairs(jnp.asarray(aid), jnp.asarray(ts), jnp.asarray(typ), plan)
    got = port_pairs.emit_pairs(torch.from_numpy(aid), torch.from_numpy(ts),
                                torch.from_numpy(typ), port_pairs.make_plan(CoVisConfig()))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("with_sess,pad_to", [(False, 0), (True, 0), (True, 2000)])
def test_emit_pairs_tagged_matches_reference(with_sess, pad_to):
    aid, ts, typ, sess = _grid(2)
    plan = ref_pairs.make_plan(RefCoVisConfig())
    want = ref_pairs.emit_pairs_tagged(
        jnp.asarray(aid), jnp.asarray(ts), jnp.asarray(typ), plan, pad_to=pad_to,
        sess=jnp.asarray(sess) if with_sess else None)
    got = port_pairs.emit_pairs_tagged(
        torch.from_numpy(aid), torch.from_numpy(ts), torch.from_numpy(typ),
        port_pairs.make_plan(CoVisConfig()), pad_to=pad_to,
        sess=torch.from_numpy(sess) if with_sess else None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape[0] == max(pad_to, aid.size * aid.shape[1])


# ---------------------------------------------------------------------------
# the device half of ops/counts.py
# ---------------------------------------------------------------------------
def _pair(aid, nxt, cnt):
    return ((torch.tensor(aid, dtype=torch.int32), torch.tensor(nxt, dtype=torch.int32),
             torch.tensor(cnt, dtype=torch.int32)),
            (jnp.asarray(aid, jnp.int32), jnp.asarray(nxt, jnp.int32),
             jnp.asarray(cnt, jnp.int32)))


def _port_table(t):
    return port_counts.CountTable(*(torch.from_numpy(np.array(x)) for x in t))


def _raw_runs(seed, n_runs=4, size=256, keys=40):
    rng = np.random.default_rng(seed)
    runs = []
    for _ in range(n_runs):
        m = rng.random(size) < 0.6
        k1 = np.where(m, rng.integers(-keys, keys, size), SENT).astype(np.int32)
        k2 = np.where(m, rng.integers(-keys, keys, size), SENT).astype(np.int32)
        runs.append(ref_counts.CountTable(jnp.asarray(k1), jnp.asarray(k2),
                                          jnp.asarray(m.astype(np.int32)),
                                          jnp.asarray(m.sum(), jnp.int32)))
    return runs


@pytest.mark.parametrize("capacity", [4, 8])
def test_merge_into_matches_reference(capacity):
    """capacity 4 overflows (keeps the top counts), 8 does not."""
    p, r = _pair([1, 2, 3, 4, 5, 6, SENT], [0, 0, 0, 0, 0, 0, 1], [10, 2, 30, 1, 50, 5, 9])
    got = port_counts.merge_into(port_counts.empty_table(capacity, "cpu"), *p)
    want = ref_counts.merge_into(ref_counts.empty_table(capacity), *r)
    _assert_tables_equal(got, want)
    if capacity == 4:
        assert table_to_dict(got) == {(5, 0): 50, (3, 0): 30, (1, 0): 10, (6, 0): 5}


@pytest.mark.parametrize("fn", ["merge_runs", "merge_runs_compact", "merge_runs_compact_raw"])
def test_run_merges_match_reference(fn):
    runs = _raw_runs(11)
    got = getattr(port_counts, fn)([_port_table(r) for r in runs])
    want = getattr(ref_counts, fn)(tuple(runs))
    _assert_tables_equal(got, want)


def test_merge_runs_compact_raw_equals_general():
    runs = [_port_table(r) for r in _raw_runs(12)]
    _assert_tables_equal(port_counts.merge_runs_compact_raw(runs),
                         port_counts.merge_runs_compact(runs))


@pytest.mark.parametrize("capacity", [16, 400])
def test_merge_bounded_tagged_matches_reference(capacity):
    stride = 1000
    rng = np.random.default_rng(3)
    n = 300
    aid = (rng.integers(0, 2, n) * stride + rng.integers(0, 20, n)).astype(np.int32)
    nxt = rng.integers(0, 20, n).astype(np.int32)
    cnt = rng.integers(1, 4, n).astype(np.int32)
    run = ref_counts.CountTable(jnp.asarray(aid), jnp.asarray(nxt), jnp.asarray(cnt),
                                jnp.int32(n))
    want = ref_counts.merge_bounded_tagged(ref_counts.empty_table(capacity), run, (3, 1), stride)
    got = port_counts.merge_bounded_tagged(port_counts.empty_table(capacity, "cpu"),
                                           _port_table(run), (3, 1), stride)
    _assert_tables_equal(got, want)


def test_prune_tagged_matches_reference():
    stride = 1000
    aid = np.array([3, 7, stride + 2, stride + 9, SENT], np.int32)
    t = ref_counts.CountTable(jnp.asarray(aid), jnp.asarray([5, 6, 7, 8, SENT], jnp.int32),
                              jnp.asarray([1, 4, 1, 2, 0], jnp.int32), jnp.int32(4))
    got = port_counts.prune_tagged(_port_table(t), (2, 1), stride)
    _assert_tables_equal(got, ref_counts.prune_tagged(t, (2, 1), stride))
    assert table_to_dict(got) == {(7, 6): 4, (stride + 2, 7): 1, (stride + 9, 8): 2}


@pytest.mark.parametrize("tag,capacity", [(0, 4), (1, 4), (1, 64), (2, 4)])
def test_extract_tag_matches_reference(tag, capacity):
    """capacity 4 truncates a tag with more rows; 64 pads the table."""
    stride = 100
    rng = np.random.default_rng(tag)
    aid = (rng.integers(0, 3, 20) * stride + rng.integers(0, 9, 20)).astype(np.int32)
    t = ref_counts.CountTable(jnp.asarray(aid), jnp.asarray(rng.integers(0, 9, 20), jnp.int32),
                              jnp.asarray(rng.integers(1, 9, 20), jnp.int32), jnp.int32(20))
    got = port_counts.extract_tag(_port_table(t), tag, stride, capacity)
    _assert_tables_equal(got, ref_counts.extract_tag(t, jnp.int32(tag), stride, capacity))


@pytest.mark.parametrize("min_count,max_pairs", [(5, 10**9), (1, 2), (100, 5)])
def test_finalize_matches_reference(min_count, max_pairs):
    p, r = _pair([1, 2, 3, 4], [9, 9, 9, 8], [10, 2, 5, 10])
    t_p = port_counts.merge_into(port_counts.empty_table(8, "cpu"), *p)
    t_r = ref_counts.merge_into(ref_counts.empty_table(8), *r)
    _assert_tables_equal(port_counts.finalize(t_p, min_count, max_pairs),
                         ref_counts.finalize(t_r, min_count, max_pairs))


def test_compress_pairs_matches_reference():
    rng = np.random.default_rng(8)
    a, b = rng.integers(0, 5, 100).astype(np.int32), rng.integers(0, 5, 100).astype(np.int32)
    v = rng.random(100) < 0.7
    got = port_counts.compress_pairs(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(v))
    want = ref_counts.compress_pairs(jnp.asarray(a), jnp.asarray(b), jnp.asarray(v))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_build_retrieval_tables_matches_reference():
    """aid 7: neighbours 1 (100), 2 (50), 3 (10); aid 8: 4 (20); first_n 2."""
    p, r = _pair([7, 7, 7, 8], [3, 1, 2, 4], [10, 100, 50, 20])
    got = port_covis.build_retrieval_tables(
        port_counts.merge_into(port_counts.empty_table(16, "cpu"), *p), 10, 2)
    want = ref_covis.build_retrieval_tables(
        ref_counts.merge_into(ref_counts.empty_table(16), *r), n_aids=10, first_n=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.neighbor[7].tolist() == [1, 2] and got.count_rel[7].tolist() == [100, 50]


# ---------------------------------------------------------------------------
# the host half of ops/counts.py
# ---------------------------------------------------------------------------
def _sorted_runs(seed, n_runs=20):
    rng = np.random.default_rng(seed)
    runs = []
    for _ in range(n_runs):
        n = int(rng.integers(10, 40))
        k1 = rng.integers(0, 30, n).astype(np.int32)
        k2 = rng.integers(0, 30, n).astype(np.int32)
        key = np.unique(k1.astype(np.int64) * 64 + k2)
        runs.append(((key // 64).astype(np.int32), (key % 64).astype(np.int32),
                     rng.integers(1, 5, len(key)).astype(np.int32)))
    return runs


@pytest.mark.parametrize("merge_every", [0, 64])
def test_host_run_store_matches_reference(merge_every):
    ref = ref_counts.HostRunStore(merge_every_rows=merge_every)
    port = port_counts.HostRunStore(merge_every_rows=merge_every)
    for run in _sorted_runs(5):
        ref.add_run(*run)
        port.add_run(*run)
    assert port.n_auto_merges == ref.n_auto_merges
    assert port.rows_spilled == ref.rows_spilled
    for g, w in zip(port.merged(), ref.merged()):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("n_threads", [1, 2])
def test_native_merge_equals_numpy(monkeypatch, n_threads):
    """The C++ cascade (built from native/kmerge.cc) and the numpy merge."""
    assert port_counts.host_merge_kind() == "c++"
    runs = []
    for k1, k2, c in _sorted_runs(7, n_runs=9):
        runs.append(((k1.astype(np.int64) << 23) | k2, c.astype(np.int64)))
    native = port_counts._merge_runs_host(runs, n_threads=n_threads)
    monkeypatch.setattr(port_counts, "_native_kmerge", lambda: None)
    assert port_counts.host_merge_kind() == "numpy"
    plain = port_counts._merge_runs_host(runs)
    for g, w in zip(native, plain):
        np.testing.assert_array_equal(g, w)
    assert len(native[0]) < sum(len(r[0]) for r in runs)


@pytest.mark.parametrize("min_count,max_pairs", [(6, 2), (1, 10), (60, 10)])
def test_host_finalize_matches_reference(min_count, max_pairs):
    aid = np.array([1, 2, 3, 4, 5], np.int32)
    nxt = np.zeros(5, np.int32)
    cnt = np.array([10, 50, 5, 30, 50], np.int32)
    got = port_counts.host_finalize(aid, nxt, cnt, min_count, max_pairs)
    for g, w in zip(got, ref_counts.host_finalize(aid, nxt, cnt, min_count, max_pairs)):
        np.testing.assert_array_equal(g, w)


def test_host_topn_tables_match_reference_and_device():
    rng = np.random.default_rng(4)
    key = np.unique(rng.integers(0, 50, 600) * 64 + rng.integers(0, 50, 600))
    aid, nxt = (key // 64).astype(np.int32), (key % 64).astype(np.int32)
    cnt = rng.integers(1, 1000, len(aid)).astype(np.int32)
    host = port_counts.host_topn_tables(aid, nxt, cnt, n_aids=50, first_n=5)
    pad = 1024 - len(aid)
    dev = port_covis.build_retrieval_tables(port_counts.CountTable(
        torch.from_numpy(np.pad(aid, (0, pad), constant_values=SENT)),
        torch.from_numpy(np.pad(nxt, (0, pad), constant_values=SENT)),
        torch.from_numpy(np.pad(cnt, (0, pad))), torch.tensor(len(aid))), 50, 5)
    want = ref_counts.host_topn_tables(aid, nxt, cnt, n_aids=50, first_n=5)
    for h, d, w in zip(host, dev, want):
        np.testing.assert_array_equal(h, w)
        np.testing.assert_array_equal(h, d.numpy())
