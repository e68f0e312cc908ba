"""K3's corpus split and its 3xTF32 arithmetic, on the CPU.

The CUDA kernel (otto_tpu_torch/csrc/mips_topk.cu) runs only on the card;
what surrounds it is held here:

- the merge: the S sorted partial lists of S corpus ranges, merged by
  `merge_partials_ref` (the merge kernel's twin), equal the twin's top-k
  over the whole corpus, bit for bit. The data is integer-valued, so every
  score is exact whatever the summation order and exact ties abound;
- `split_plan`: when the corpus is split, and into which ranges;
- the precision of 3xTF32: a numpy emulation of the kernel's scores
  (operands split into TF32 hi and lo, lo.hi + hi.lo + hi.hi per k8 step
  into float32 accumulators) against float64, and its top-k against the
  twin's.
"""
import numpy as np
import pytest
import torch

from otto_tpu_torch.ops.kernels import mips
import torch_threads  # noqa: F401

# as chip_smoke.py and tests/test_torch_cuda.py hold the kernel to the twin:
# scores within MIPS_TOL * (1 + the largest |score|), an index differing
# only at a near-tie (rescored in float64 within that tolerance), at most
# max(2, n / 1000) of them
MIPS_TOL = 1e-4


def _int_data(seed, Q, V, D):
    rng = np.random.default_rng(seed)
    q = rng.integers(-3, 4, size=(Q, D)).astype(np.float32)
    c = rng.integers(-3, 4, size=(V, D)).astype(np.float32)
    return torch.from_numpy(q), torch.from_numpy(c)


def _partials(q, c, k, metric, bounds):
    """The twin's sorted top-k of each corpus range, global indices,
    stacked [S, Q, k] as the kernel writes its scratch."""
    ps, pi = [], []
    for v0, v1 in bounds:
        s, i = mips.mips_topk_ref(q, c[v0:v1], k, metric)
        ps.append(s)
        pi.append(torch.where(i >= 0, i + v0, i))
    if not bounds:
        empty = torch.empty((0, q.shape[0], k))
        return empty, empty.to(torch.int32)
    return torch.stack(ps), torch.stack(pi)


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("V,k,S,chunk", [
    pytest.param(300, 5, 3, 128, id="tie-across-boundaries"),
    pytest.param(30, 20, 4, 8, id="ranges-shorter-than-k"),
    pytest.param(7, 10, 2, 4, id="V-below-k"),
    pytest.param(500, 20, 1, 512, id="S1"),
    pytest.param(0, 20, 1, 64, id="V0"),
])
def test_merge_of_split_partials_equals_whole_corpus(metric, V, k, S, chunk):
    q, c = _int_data(0, 9, V, 12)
    if V == 300:
        # rows 127 | 128 | 256: one exact tie on either side of both split
        # boundaries; query 0 is that row, so the three lead its list
        c[128] = c[127]
        c[256] = c[127]
        q[0] = c[127]
    bounds = mips.split_bounds(V, S, chunk)
    assert bounds[0][0] == 0 and bounds[-1][1] == V
    got = mips.merge_partials_ref(*_partials(q, c, k, metric, bounds), k)
    want = mips.mips_topk_ref(q, c, k, metric)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    if V == 300:
        assert got[1][0, :3].tolist() == [127, 128, 256]
    if V < k:
        assert (got[1][:, V:] == -1).all() and (got[0][:, V:] == mips.NEG_INF).all()


def test_merge_of_no_partials_is_all_missing():
    """V = 0: the kernel launches only the merge, over S = 0 lists."""
    q, c = _int_data(1, 4, 0, 8)
    got = mips.merge_partials_ref(*_partials(q, c, 6, "l2", []), 6)
    want = mips.mips_topk_ref(q, c, 6, "l2")
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert (got[1] == -1).all()


@pytest.mark.parametrize("Q,V,n_sm,split", [
    (16384, 1_800_000, 132, False),   # a knn_search query block: one wave
    (10176, 1_800_000, 132, False),   # the last block of a 600k search
    (1000, 100_000, 132, True),
    (2048, 200_000, 132, True),
    (1, 100_003, 132, True),
    (64, 1088, 132, True),            # 17 tiles: two ranges of 8 and 9
    (64, 900, 132, False),            # 15 tiles: a second range would be short
    (3, 0, 132, False),
    (300, 5000, 4, False),            # 3 blocks on 4 SMs: no room for two
])
def test_split_plan(Q, V, n_sm, split):
    S, chunk = mips.split_plan(Q, V, n_sm)
    assert (S > 1) == split
    assert chunk % mips.TILE_V == 0
    bounds = mips.split_bounds(V, S, chunk)
    assert len(bounds) == S and bounds[0][0] == 0 and bounds[-1][1] == V
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    if S > 1:
        # no range empty or short, and blocks x ranges fits in one wave
        tiles = [-(-(v1 - v0) // mips.TILE_V) for v0, v1 in bounds]
        assert min(tiles) >= mips.MIN_SPLIT_TILES
        assert -(-Q // mips.BLOCK_Q) * S <= n_sm


# --------------------------------------------------------------------------
# 3xTF32, emulated
# --------------------------------------------------------------------------
def _tf32(x, rounding):
    """float32 -> TF32 (10 explicit mantissa bits) as float32: the 13 low
    bits rounded to nearest, ties away from zero ('rna', cvt.rna.tf32.f32
    and the kernel's integer form) or to even ('rne')."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    if rounding == "rna":
        b = b + np.uint32(0x1000)
    else:
        b = b + np.uint32(0x0FFF) + ((b >> np.uint32(13)) & np.uint32(1))
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x, rounding):
    hi = _tf32(x, rounding)
    return hi, _tf32(x - hi, rounding)


def _emulated_dot(q, c, rounding, passes):
    """q . c as the kernel sums it: per k8 step the products of TF32
    operands (exact in float64) of each pass go into float32 accumulators,
    in the kernel's order lo_q.hi_c, hi_q.lo_c, hi_q.hi_c (passes = 3), or
    hi_q.hi_c alone (passes = 1, single-pass TF32)."""
    qh, ql = _split(q, rounding)
    ch, cl = _split(c, rounding)
    terms = [(ql, ch), (qh, cl), (qh, ch)] if passes == 3 else [(qh, ch)]
    acc = np.zeros((q.shape[0], c.shape[0]), np.float32)
    for d in range(0, q.shape[1], 8):
        for a, b in terms:
            prod = a[:, d:d + 8].astype(np.float64) @ b[:, d:d + 8].astype(np.float64).T
            acc = (acc + prod.astype(np.float32)).astype(np.float32)
    return acc


def _scores(q, c, metric, dot):
    if metric == "dot":
        return dot
    qsq = mips.sq_norms(torch.from_numpy(q)).numpy()
    csq = mips.sq_norms(torch.from_numpy(c)).numpy()
    return (np.float32(2.0) * dot - qsq[:, None] - csq[None, :]).astype(np.float32)


def _exact(q, c, metric):
    q64, c64 = q.astype(np.float64), c.astype(np.float64)
    s = q64 @ c64.T
    if metric == "l2":
        s = 2 * s - (q64 * q64).sum(1)[:, None] - (c64 * c64).sum(1)[None, :]
    return s


@pytest.mark.parametrize("rounding", ["rna", "rne"])
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_3xtf32_emulation_stays_near_float64(metric, rounding):
    """chip_smoke's K3 data (0.3 randn, D = 100): 3xTF32 scores within
    MIPS_TOL of float64 (far inside it), single-pass TF32 farther out; the
    emulated top-k agrees with the twin's up to rescored near-ties."""
    rng = np.random.default_rng(7)
    Q, V, D, k = 48, 3000, 100, 20
    q = (0.3 * rng.standard_normal((Q, D))).astype(np.float32)
    c = (0.3 * rng.standard_normal((V, D))).astype(np.float32)
    exact = _exact(q, c, metric)
    tol = MIPS_TOL * (1.0 + np.abs(exact).max())
    three = _scores(q, c, metric, _emulated_dot(q, c, rounding, 3))
    one = _scores(q, c, metric, _emulated_dot(q, c, rounding, 1))
    err3 = np.abs(three - exact).max()
    err1 = np.abs(one - exact).max()
    assert err3 <= tol
    assert err1 > 10 * err3

    # the emulated kernel's top-k, ordered (score desc, index asc)
    order = np.lexsort((np.broadcast_to(np.arange(V), three.shape), -three), axis=1)
    got_i = order[:, :k]
    want_s, want_i = mips.mips_topk_ref(torch.from_numpy(q), torch.from_numpy(c), k, metric)
    want_s, want_i = want_s.numpy(), want_i.numpy()
    assert np.abs(np.take_along_axis(three, got_i, 1) - want_s).max() <= tol
    diff = got_i != want_i
    if diff.any():
        rescored = exact[np.nonzero(diff)[0], got_i[diff]]
        assert np.abs(rescored - want_s[diff]).max() <= tol
        assert diff.sum() <= max(2, diff.size // 1000)
