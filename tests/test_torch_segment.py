"""Row-wise segment primitives and Stage A stats: otto_tpu_torch against
otto_tpu.ops.segment / otto_tpu.engine.session_stats, bit for bit.

Inputs come from numpy with a fixed seed and carry SENTINEL lanes, ties
and negative keys: SENTINEL must sort last and ties must keep their input
order in both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.engine import session_stats as ref_stats
from otto_tpu.ops import segment as ref_seg
from otto_tpu_torch.engine import session_stats as port_stats
from otto_tpu_torch.ops import segment as port_seg
import torch_threads  # noqa: F401

S, C = 7, 300  # odd row count, lanes not a multiple of 128


def _keys(seed, lo=-20, hi=20, sent_frac=0.2):
    """int32 keys with negatives, many ties and SENTINEL lanes."""
    rng = np.random.default_rng(seed)
    k = rng.integers(lo, hi, (S, C)).astype(np.int32)
    k[rng.random((S, C)) < sent_frac] = ref_seg.SENTINEL
    return k


def _cols(seed):
    rng = np.random.default_rng(seed)
    return {
        "a": (rng.integers(-1000, 1000, (S, C)).astype(np.int32), "sum"),
        "b": (rng.integers(-1000, 1000, (S, C)).astype(np.int32), "min"),
        "c": (rng.integers(-1000, 1000, (S, C)).astype(np.int32), "max"),
        "d": (rng.normal(size=(S, C)).astype(np.float32), "min"),
        "e": (rng.normal(size=(S, C)).astype(np.float32), "max"),
        "f": (rng.integers(0, 4, (S, C)).astype(np.float32), "sum"),
    }


def _j(cols):
    return {n: (jnp.asarray(a), r) for n, (a, r) in cols.items()}


def _t(cols):
    return {n: (torch.from_numpy(a), r) for n, (a, r) in cols.items()}


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_constants():
    assert port_seg.SENTINEL == int(ref_seg.SENTINEL)
    assert port_seg.NEG_SENTINEL == int(ref_seg.NEG_SENTINEL)


@pytest.mark.parametrize("n_keys", [1, 2, 3])
def test_rowwise_sort(n_keys):
    keys = [_keys(10 + i, -3, 3) for i in range(n_keys)]
    vals = [np.random.default_rng(1).integers(0, 99, (S, C)).astype(np.int32),
            np.random.default_rng(2).normal(size=(S, C)).astype(np.float32)]
    wk, wv = ref_seg.rowwise_sort(
        tuple(map(jnp.asarray, keys)), tuple(map(jnp.asarray, vals)))
    gk, gv = port_seg.rowwise_sort(
        [torch.from_numpy(k) for k in keys], [torch.from_numpy(v) for v in vals])
    for g, w in zip(gk + gv, list(wk) + list(wv)):
        _eq(g, w)


def test_rowwise_transport_sort():
    key = _keys(3)
    cols = _cols(4)
    arrays = [a for a, _ in cols.values()]
    wk, wout = ref_seg.rowwise_transport_sort(
        jnp.asarray(key), [jnp.asarray(a) for a in arrays])
    gk, gout = port_seg.rowwise_transport_sort(
        torch.from_numpy(key), [torch.from_numpy(a) for a in arrays])
    _eq(gk, wk)
    for g, w in zip(gout, wout):
        assert g.numpy().dtype == np.asarray(w).dtype
        _eq(g, w)


def test_rowwise_transport_sort_reads_columns_in_place(monkeypatch):
    """The sort hands K1 its columns as they are: no torch.stack, and
    non-contiguous column views sort as otto_tpu sorts their copies."""
    key = _keys(13)
    rng = np.random.default_rng(14)
    wide = rng.integers(-1000, 1000, (S, 3 * C)).astype(np.int32)
    arrays = [wide[:, 1:C + 1], wide[:, C + 1:2 * C + 1],
              rng.normal(size=(C, S)).astype(np.float32).T]
    wk, wout = ref_seg.rowwise_transport_sort(
        jnp.asarray(key), [jnp.asarray(np.ascontiguousarray(a)) for a in arrays])
    wt = torch.from_numpy(wide)
    cols = [wt[:, 1:C + 1], wt[:, C + 1:2 * C + 1], torch.from_numpy(arrays[2].T.copy()).t()]

    def no_stack(*a, **k):
        raise AssertionError("rowwise_transport_sort stacked its columns")

    monkeypatch.setattr(torch, "stack", no_stack)
    # the twin stacks on the CPU: hold the sort to the kernel's list form
    # through a twin that gathers column by column
    from otto_tpu_torch.ops.kernels import gather

    monkeypatch.setattr(gather, "gather_rows_ref", lambda v, ix: torch.cat(
        [torch.gather(c, 1, ix.long())[None] for c in v]))
    gk, gout = port_seg.rowwise_transport_sort(torch.from_numpy(key), cols)
    _eq(gk, wk)
    for g, w in zip(gout, wout):
        assert g.numpy().dtype == np.asarray(w).dtype
        _eq(g, w)


@pytest.mark.parametrize("max_cols", [1, 2, 64])
def test_rowwise_groupby_scan_column_chunks(monkeypatch, max_cols):
    """More columns of one dtype than a K1 launch takes go in several
    launches, with outputs unchanged against otto_tpu."""
    monkeypatch.setattr(port_seg, "MAX_COLS", max_cols)
    key = _keys(15)
    cols = _cols(16)
    cols["g"] = (np.random.default_rng(17).integers(0, 5, (S, C)).astype(np.int32),
                 "carry")
    wk, wout, wend, wn = ref_seg.rowwise_groupby_scan(jnp.asarray(key), _j(cols))
    gk, gout, gend, gn = port_seg.rowwise_groupby_scan(torch.from_numpy(key), _t(cols))
    _eq(gk, wk)
    _eq(gend, wend)
    _eq(gn, wn)
    for n in cols:
        _eq(gout[n], wout[n])


@pytest.mark.parametrize("seed", [5, 6])
def test_segmented_scan(seed):
    rng = np.random.default_rng(seed)
    for dtype in (np.int32, np.float32):
        vals = rng.integers(-100, 100, (3, S, C)).astype(dtype)
        first = rng.random((S, C)) < 0.1
        for red in ("sum", "min", "max"):
            (want,) = ref_seg.segmented_scan(
                (jnp.asarray(vals),), (red,), jnp.asarray(first)[None], axis=2)
            got = port_seg.segmented_scan(
                torch.from_numpy(vals), torch.from_numpy(first), red)
            _eq(got, want)


def test_rowwise_groupby_scan():
    key = _keys(7)
    cols = _cols(8)
    cols["g"] = (np.random.default_rng(9).integers(0, 5, (S, C)).astype(np.int32),
                 "carry")
    wk, wout, wend, wn = ref_seg.rowwise_groupby_scan(jnp.asarray(key), _j(cols))
    gk, gout, gend, gn = port_seg.rowwise_groupby_scan(torch.from_numpy(key), _t(cols))
    _eq(gk, wk)
    _eq(gend, wend)
    _eq(gn, wn)
    assert list(gout) == list(wout)
    for n in cols:
        _eq(gout[n], wout[n])


@pytest.mark.parametrize("seed", [11, 12])
def test_rowwise_groupby(seed):
    key = _keys(seed)
    cols = _cols(seed + 100)
    wk, wout, wn = ref_seg.rowwise_groupby(jnp.asarray(key), _j(cols))
    gk, gout, gn = port_seg.rowwise_groupby(torch.from_numpy(key), _t(cols))
    _eq(gk, wk)
    _eq(gn, wn)
    for n in cols:
        _eq(gout[n], wout[n])


@pytest.mark.parametrize("fn", ["rowwise_rank_desc", "rowwise_rank_asc"])
def test_rowwise_rank(fn):
    rng = np.random.default_rng(13)
    value = rng.integers(-5, 5, (S, C)).astype(np.int32)   # many ties
    valid = rng.random((S, C)) < 0.8
    want = getattr(ref_seg, fn)(jnp.asarray(value), jnp.asarray(valid))
    got = getattr(port_seg, fn)(torch.from_numpy(value), torch.from_numpy(valid))
    _eq(got, want)


def _sessions(seed, L=24):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, S)
    pad = np.arange(L)[None, :] >= lens[:, None]
    aid = np.where(pad, -1, rng.integers(0, 12, (S, L))).astype(np.int32)
    ts = np.where(pad, 0, np.sort(rng.integers(0, 20_000, (S, L)), axis=1))
    typ = np.where(pad, 0, rng.choice(3, (S, L), p=[0.7, 0.2, 0.1]))
    return aid, ts.astype(np.int32), typ.astype(np.int32)


def test_compute_session_stats():
    ev = _sessions(21)
    want = ref_stats.compute_session_stats(*map(jnp.asarray, ev))
    got = port_stats.compute_session_stats(*map(torch.from_numpy, ev))
    assert got._fields == want._fields
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("keep_aids", [5, 24])
def test_compute_session_aids(keep_aids):
    ev = _sessions(22)
    want = ref_stats.compute_session_aids(*map(jnp.asarray, ev), keep_aids)
    got = port_stats.compute_session_aids(*map(torch.from_numpy, ev), keep_aids)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


# ---------------------------------------------------------------------------
# the flat (1-D) half: composite int32 keys, int32 sums, stable ranks
# ---------------------------------------------------------------------------
N = 1000


def _flat(seed, lo=-8, hi=8, sent_frac=0.15):
    """(k1, k2, v, valid): negative keys, many duplicates, SENTINEL rows and
    the int32 extremes among the keys, sums that wrap int32."""
    rng = np.random.default_rng(seed)
    k1 = rng.integers(lo, hi, N).astype(np.int32)
    k2 = rng.integers(lo, hi, N).astype(np.int32)
    k1[:3] = (-2**31, 2**31 - 2, ref_seg.NEG_SENTINEL)
    k2[:3] = (2**31 - 2, -2**31, 5)
    sent = rng.random(N) < sent_frac
    k1[sent] = ref_seg.SENTINEL
    k2[sent] = ref_seg.SENTINEL
    v = rng.integers(-2**30, 2**30, N).astype(np.int32)
    valid = rng.random(N) < 0.9
    return k1, k2, v, valid


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_sort_compress(seed, with_valid):
    k1, k2, v, valid = _flat(seed)
    j = [jnp.asarray(x) for x in (k1, k2, v)]
    t = [torch.from_numpy(x) for x in (k1, k2, v)]
    want = ref_seg.sort_compress(*j, jnp.asarray(valid) if with_valid else None)
    got = port_seg.sort_compress(*t, torch.from_numpy(valid) if with_valid else None)
    for g, w in zip(got, want):
        _eq(g, w)
        assert g.dtype == torch.int32


def test_sort_compress_ends():
    k1, k2, v, _ = _flat(2)
    want = ref_seg.sort_compress_ends(*(jnp.asarray(x) for x in (k1, k2, v)))
    got = port_seg.sort_compress_ends(*(torch.from_numpy(x) for x in (k1, k2, v)))
    for g, w in zip(got, want):
        _eq(g, w)


def test_sort_compress_multi():
    k1, k2, v, valid = _flat(3)
    v2 = np.random.default_rng(4).integers(0, 9, N).astype(np.int32)
    wk1, wk2, wv, wn = ref_seg.sort_compress_multi(
        jnp.asarray(k1), jnp.asarray(k2), (jnp.asarray(v), jnp.asarray(v2)),
        jnp.asarray(valid))
    gk1, gk2, gv, gn = port_seg.sort_compress_multi(
        torch.from_numpy(k1), torch.from_numpy(k2),
        (torch.from_numpy(v), torch.from_numpy(v2)), torch.from_numpy(valid))
    for g, w in zip((gk1, gk2, *gv, gn), (wk1, wk2, *wv, wn)):
        _eq(g, w)
    with pytest.raises(TypeError):
        port_seg.sort_compress(torch.from_numpy(k1), torch.from_numpy(k2),
                               torch.from_numpy(v).float())


def test_sort_compress_all_invalid():
    k1, k2, v, _ = _flat(5)
    none = np.zeros(N, bool)
    uk1, uk2, uv, n = port_seg.sort_compress(
        *(torch.from_numpy(x) for x in (k1, k2, v)), torch.from_numpy(none))
    assert int(n) == 0 and bool((uk1 == port_seg.SENTINEL).all())
    assert bool((uv == 0).all())


@pytest.mark.parametrize("n_keys", [1, 2, 3])
def test_sort_by_keys(n_keys):
    rng = np.random.default_rng(20 + n_keys)
    keys = [rng.integers(-3, 3, N).astype(np.int32) for _ in range(n_keys)]
    vals = [np.arange(N, dtype=np.int32), rng.normal(size=N).astype(np.float32)]
    wk, wv = ref_seg.sort_by_keys(tuple(map(jnp.asarray, keys)),
                                  tuple(map(jnp.asarray, vals)))
    gk, gv = port_seg.sort_by_keys([torch.from_numpy(k) for k in keys],
                                   [torch.from_numpy(x) for x in vals])
    for g, w in zip(gk + gv, list(wk) + list(wv)):
        _eq(g, w)


def test_segment_starts():
    seg_sorted = np.sort(np.random.default_rng(7).integers(-4, 9, N)).astype(np.int32)
    _eq(port_seg.segment_starts(torch.from_numpy(seg_sorted)),
        ref_seg.segment_starts(jnp.asarray(seg_sorted)))


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("fn", ["ordinal_rank_desc", "ordinal_rank_asc"])
def test_ordinal_rank(fn, with_valid):
    rng = np.random.default_rng(8)
    group = rng.integers(-3, 4, N).astype(np.int32)
    value = rng.integers(-5, 5, N).astype(np.int32)     # many ties
    valid = rng.random(N) < 0.8
    want = getattr(ref_seg, fn)(jnp.asarray(group), jnp.asarray(value),
                                jnp.asarray(valid) if with_valid else None)
    got = getattr(port_seg, fn)(torch.from_numpy(group), torch.from_numpy(value),
                                torch.from_numpy(valid) if with_valid else None)
    _eq(got, want)


@pytest.mark.parametrize("order_by", [False, True])
def test_build_topn_tables(order_by):
    rng = np.random.default_rng(9)
    key = rng.integers(0, 40, N).astype(np.int32)        # 0..39 of 30 keys
    key[rng.random(N) < 0.1] = ref_seg.SENTINEL
    nbr = rng.integers(0, 99, N).astype(np.int32)
    v1 = rng.integers(0, 50, N).astype(np.int32)
    v2 = rng.normal(size=N).astype(np.float32)
    order = rng.integers(0, 7, N).astype(np.int32)
    wn, wv = ref_seg.build_topn_tables(
        jnp.asarray(key), jnp.asarray(nbr), (jnp.asarray(v1), jnp.asarray(v2)), 30, 5,
        order_by=jnp.asarray(order) if order_by else None)
    gn, gv = port_seg.build_topn_tables(
        torch.from_numpy(key), torch.from_numpy(nbr),
        (torch.from_numpy(v1), torch.from_numpy(v2)), 30, 5,
        order_by=torch.from_numpy(order) if order_by else None)
    _eq(gn, wn)
    for g, w in zip(gv, wv):
        _eq(g, w)
        assert g.numpy().dtype == np.asarray(w).dtype


def test_rowwise_unique_sum():
    key = _keys(30, 0, 12)
    vals = [np.random.default_rng(31).integers(-9, 9, (S, C)).astype(np.int32),
            np.random.default_rng(32).integers(0, 4, (S, C)).astype(np.float32)]
    wk, wv, wn = ref_seg.rowwise_unique_sum(jnp.asarray(key), tuple(map(jnp.asarray, vals)))
    gk, gv, gn = port_seg.rowwise_unique_sum(torch.from_numpy(key),
                                             [torch.from_numpy(v) for v in vals])
    for g, w in zip((gk, *gv, gn), (wk, *wv, wn)):
        _eq(g, w)


def test_rowwise_segment_reduce():
    key = _keys(33, 0, 12)
    rng = np.random.default_rng(34)
    vals = [rng.integers(-9, 9, (S, C)).astype(np.int32) for _ in range(4)]
    reducers = ("max", "min", "sum", "count")
    wk, wv, wn = ref_seg.rowwise_segment_reduce(
        jnp.asarray(key), tuple(map(jnp.asarray, vals)), reducers)
    gk, gv, gn = port_seg.rowwise_segment_reduce(
        torch.from_numpy(key), [torch.from_numpy(v) for v in vals], reducers)
    for g, w in zip((gk, *gv, gn), (wk, *wv, wn)):
        _eq(g, w)
