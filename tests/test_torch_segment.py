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
