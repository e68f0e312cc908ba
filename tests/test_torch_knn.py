"""K3 and the kNN search against otto_tpu.

The port's twin `mips_topk_ref` (what a CPU tensor runs) is held against
otto_tpu's Pallas kernel `mips_topk_pallas` in interpret mode, and the
port's `knn_search` against otto_tpu's `knn_search` on the CPU (its XLA
path).

Tolerance: scores within 1e-5 (relative and absolute). Both sides sum the
same float32 products in another order (torch's matmul vs XLA's dot), and
write the l2 score differently (2s - |q|^2 - |c|^2 here and in the Pallas
kernel, -(|q|^2 + |c|^2 - 2s) on otto_tpu's XLA path): a few ulps at
scores of magnitude ~30. Indices are equal: the data has no near-ties
except the exact duplicate rows of the tie test, whose scores are
bit-equal on every side.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.ops.knn import knn_search as ref_knn_search
from otto_tpu.ops.pallas.mips import mips_topk_pallas
from otto_tpu_torch.ops import knn
from otto_tpu_torch.ops.kernels import mips
import torch_threads  # noqa: F401

TOL = 1e-5


def _data(seed, Q, V, D, shift=0.0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(Q, D)).astype(np.float32)
    c = (rng.normal(size=(V, D)) + shift).astype(np.float32)
    return q, c


def _port(q, c, k, metric):
    s, i = mips.mips_topk_ref(torch.from_numpy(q), torch.from_numpy(c), k, metric)
    return s.numpy(), i.numpy()


# the cases of tests/test_pallas_mips.py: (Q, V, D, k, bq, bv, corpus shift)
PALLAS_CASES = [
    pytest.param(8, 300, 16, 5, 8, 128, 0.0, id="bruteforce"),
    pytest.param(16, 200, 8, 3, 16, 64, 0.0, id="self"),
    pytest.param(4, 100, 8, 4, 4, 64, 5.0, id="padding"),
]


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("Q,V,D,k,bq,bv,shift", PALLAS_CASES)
def test_twin_matches_pallas_interpret(metric, Q, V, D, k, bq, bv, shift):
    q, c = _data(0, Q, V, D, shift)
    if Q == 16:
        q = c[:16].copy()
    want_s, want_i = mips_topk_pallas(
        jnp.asarray(q), jnp.asarray(c), k, metric, bq=bq, bv=bv, interpret=True)
    got_s, got_i = _port(q, c, k, metric)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_allclose(got_s, np.asarray(want_s), rtol=TOL, atol=TOL)
    assert got_i.dtype == np.int32 and got_s.dtype == np.float32


def test_twin_self_nearest():
    _, c = _data(1, 0, 200, 8)
    s, i = _port(c[:16], c, 3, "l2")
    assert i[:, 0].tolist() == list(range(16))
    np.testing.assert_allclose(s[:, 0], 0.0, atol=1e-4)


@pytest.mark.parametrize("metric", ["l2", "dot", "cos"])
@pytest.mark.parametrize("V,tile", [(500, 128), (37, 64)])
def test_knn_search_matches_reference(metric, V, tile):
    q, c = _data(2, 40, V, 16)
    want_s, want_i = ref_knn_search(q, c, 20, metric=metric, tile=tile, backend="xla")
    got_s, got_i = knn.knn_search(torch.from_numpy(q), torch.from_numpy(c), 20, metric)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=TOL, atol=TOL)


def test_duplicate_rows_lower_index_first():
    """Corpus rows 3, 5 and 200 are identical and the query is row 3: the
    port gives the lower index first, as otto_tpu's CPU path does. (The
    Pallas kernel, with 128-row tiles, puts row 200 of the later tile
    first: an artefact of its [tile ++ best] pool, not followed.)"""
    _, c = _data(3, 0, 400, 16)
    c[5] = c[3]
    c[200] = c[3]
    q = c[3:4].copy()
    want_s, want_i = ref_knn_search(q, c, 4, metric="l2", tile=128, backend="xla")
    got_s, got_i = knn.knn_search(torch.from_numpy(q), torch.from_numpy(c), 4)
    assert got_i[0, :3].tolist() == [3, 5, 200]
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=TOL, atol=TOL)
    _, pallas_i = mips_topk_pallas(jnp.asarray(q), jnp.asarray(c), 4, "l2",
                                   bq=8, bv=128, interpret=True)
    assert np.asarray(pallas_i)[0, :3].tolist() == [200, 3, 5]


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_fewer_rows_than_k_pad_like_pallas(metric):
    """V < k: the missing entries are index -1, score -3.4e38, as the Pallas
    kernel returns them; the real entries match otto_tpu's CPU path."""
    q, c = _data(4, 6, 7, 8)
    want_s, want_i = mips_topk_pallas(jnp.asarray(q), jnp.asarray(c), 10, metric,
                                      bq=8, bv=128, interpret=True)
    got_s, got_i = knn.knn_search(torch.from_numpy(q), torch.from_numpy(c), 10, metric)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=TOL, atol=TOL)
    assert (got_i[:, 7:] == -1).all() and (got_s[:, 7:] == mips.NEG_INF).all()
    cpu_s, cpu_i = ref_knn_search(q, c, 10, metric=metric, backend="xla")
    np.testing.assert_array_equal(got_i[:, :7].numpy(), cpu_i[:, :7])
    np.testing.assert_allclose(got_s[:, :7].numpy(), cpu_s[:, :7], rtol=TOL, atol=TOL)


def test_query_blocks_do_not_change_the_result():
    q, c = _data(5, 50, 300, 16)
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    one = knn.knn_search(qt, ct, 20)
    blocks = knn.knn_search(qt, ct, 20, query_block=7)
    # the CPU matmul may block a 7-row product differently: scores to TOL
    assert torch.equal(one[1], blocks[1])
    torch.testing.assert_close(one[0], blocks[0], rtol=TOL, atol=TOL)


def test_twin_tile_does_not_change_the_result():
    q, c = _data(6, 9, 1000, 16)
    c[700] = c[10]   # an exact tie across tiles
    q[0] = c[10]
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    a = mips.mips_topk_ref(qt, ct, 20, "l2", tile=8192)
    b = mips.mips_topk_ref(qt, ct, 20, "l2", tile=96)
    assert torch.equal(a[1], b[1])
    assert a[1][0, :2].tolist() == [10, 700]
    torch.testing.assert_close(a[0], b[0], rtol=TOL, atol=TOL)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((3, 8))
    with pytest.raises(ValueError):
        mips.mips_topk(q, q, 33)          # k above one lane per entry
    with pytest.raises(ValueError):
        mips.mips_topk(q, q, 2, "cos")    # cos is knn_search's, not the kernel's
    with pytest.raises(TypeError):
        mips.mips_topk(q.double(), q.double(), 2)
    with pytest.raises(ValueError):
        D = mips.MAX_D + 1                # past the k8 steps the kernel is built for
        mips.mips_topk(torch.zeros((3, D)), torch.zeros((3, D)), 2)
    with pytest.raises(ValueError):
        mips.mips_topk(q.to("meta"), q.to("meta"), 2)
