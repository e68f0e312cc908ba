"""The kernels' plain twins against otto_tpu's Pallas kernels.

gather_rows_ref (K1) and segmented_scan_ref (K2) are what the port runs on
the CPU and what the CUDA kernels are held to on the card, so each twin is
compared with the Pallas kernel as otto_tpu's own tests run it (interpret
mode), on the cases of tests/test_pallas_gather.py and
tests/test_pallas_segscan.py. The CUDA kernels themselves run only on the
card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.ops.pallas.gather import gather_rows as pallas_gather_rows
from otto_tpu.ops.pallas.segscan import segmented_scan_pallas
from otto_tpu_torch.ops.kernels import gather, segscan


def _vals(rng, shape, dtype):
    if np.issubdtype(dtype, np.floating):
        return rng.normal(size=shape).astype(dtype)
    return rng.integers(-100, 100, shape).astype(dtype)


# how gather_rows is given its B columns: one [B, S, P] tensor, or a list
# or tuple of B [S, P] tensors
FORMS = ["stacked", "list", "tuple"]


def _check_gather(vals, idx, form):
    want = np.asarray(
        pallas_gather_rows(jnp.asarray(vals), jnp.asarray(idx), interpret=True)
    )
    cols = torch.from_numpy(vals)
    if form == "list":
        cols = [torch.from_numpy(v.copy()) for v in vals]
    elif form == "tuple":
        cols = tuple(torch.from_numpy(v.copy()) for v in vals)
    ix = torch.from_numpy(idx)
    # a gather moves words: bit-equal for every dtype, kernel and twin
    for got in (gather.gather_rows(cols, ix), gather.gather_rows_ref(cols, ix)):
        assert got.dtype == torch.from_numpy(vals).dtype
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_gather_permutation_odd_shapes(dtype, form):
    rng = np.random.default_rng(7)
    B, S, P = 3, 9, 300  # odd S, P not a multiple of 128
    vals = _vals(rng, (B, S, P), dtype)
    idx = np.stack([rng.permutation(P) for _ in range(S)]).astype(np.int32)
    _check_gather(vals, idx, form)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_gather_repeated_indices(dtype, form):
    rng = np.random.default_rng(8)
    B, S, P = 2, 8, 256
    vals = _vals(rng, (B, S, P), dtype)
    idx = rng.integers(0, P, (S, P)).astype(np.int32)  # not a permutation
    _check_gather(vals, idx, form)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("W", [150, 40])
def test_gather_width_differs(W, form):
    """W != P, as in the GBDT tree walk (T tree columns from F features)."""
    rng = np.random.default_rng(9)
    B, S, P = 1, 37, 104
    vals = rng.integers(0, 64, (B, S, P)).astype(np.int32)
    idx = rng.integers(0, P, (S, W)).astype(np.int32)
    _check_gather(vals, idx, form)


def test_gather_column_views():
    """Non-contiguous and offset column views give the contiguous answer."""
    rng = np.random.default_rng(10)
    wide = torch.from_numpy(rng.integers(-9, 9, (5, 2 * 33 + 1)).astype(np.int32))
    cols = [wide[:, 1:34], wide[:, 34:], wide.t()[:33].t()[:, :33]]
    idx = torch.from_numpy(rng.integers(0, 33, (5, 20)).astype(np.int32))
    want = gather.gather_rows(torch.stack([c.contiguous() for c in cols]), idx)
    assert torch.equal(gather.gather_rows(cols, idx), want)


def test_gather_rejects_bad_column_lists():
    ix = torch.zeros((4, 8), dtype=torch.int32)
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError):      # mixed dtypes
        gather.gather_rows([a, a.float()], ix)
    with pytest.raises(ValueError):     # mixed devices
        gather.gather_rows([a, a.to("meta")], ix)
    with pytest.raises(ValueError):     # shapes differ
        gather.gather_rows([a, a[:, :4]], ix)
    with pytest.raises(ValueError):     # not [S, P]
        gather.gather_rows([a[None]], ix)
    with pytest.raises(ValueError):     # no column to take a shape from
        gather.gather_rows([], ix)


def test_gather_rejects_too_many_columns():
    """B above the kernel's column pointers is refused in either form."""
    ix = torch.zeros((2, 3), dtype=torch.int32)
    cols = [torch.zeros((2, 3), dtype=torch.int32)] * (gather.MAX_COLS + 1)
    with pytest.raises(ValueError, match="column pointers"):
        gather.gather_rows(cols, ix)
    with pytest.raises(ValueError, match="column pointers"):
        gather.gather_rows(torch.zeros((gather.MAX_COLS + 1, 2, 3), dtype=torch.int32), ix)
    # at the limit it runs
    out = gather.gather_rows(cols[:gather.MAX_COLS], ix)
    assert out.shape == (gather.MAX_COLS, 2, 3)


def test_gather_rejects_rows_above_shared_memory():
    """One source row and one index row must fit a block's shared memory:
    P + W = 58108 words fit (16 + 4P + 4W bytes = SMEM_BYTES), one more
    word does not."""
    W = 8
    P_max = (gather.SMEM_BYTES - 16) // 4 - W
    ix = torch.zeros((1, W), dtype=torch.int32)
    out = gather.gather_rows(torch.ones((1, 1, P_max), dtype=torch.float32), ix)
    assert torch.equal(out, torch.ones((1, 1, W)))
    with pytest.raises(ValueError, match="shared memory"):
        gather.gather_rows(torch.zeros((1, 1, P_max + 1), dtype=torch.float32), ix)
    with pytest.raises(ValueError, match="shared memory"):
        gather.gather_rows([torch.zeros((1, P_max + 1), dtype=torch.int32)], ix)


def test_gather_rejects_bad_inputs():
    v = torch.zeros((1, 4, 8), dtype=torch.int64)
    with pytest.raises(TypeError):
        gather.gather_rows(v, torch.zeros((4, 8), dtype=torch.int32))
    v = torch.zeros((1, 4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        gather.gather_rows(v, torch.zeros((3, 8), dtype=torch.int32))
    with pytest.raises(IndexError):
        gather.gather_rows(v, torch.full((4, 8), 8, dtype=torch.int32), check=True)


def _check_scan(vals, first, red):
    want = np.asarray(
        segmented_scan_pallas(jnp.asarray(vals), jnp.asarray(first), red,
                              interpret=True)
    )
    got = segscan.segmented_scan(
        torch.from_numpy(vals), torch.from_numpy(first), red
    ).numpy()
    if red == "sum" and np.issubdtype(vals.dtype, np.floating):
        # float sums: the Hillis-Steele twin and the chunked Pallas scan
        # reduce in different association orders
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        # int32 results and float min/max are exact
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("red", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_segscan_matches_pallas(red, dtype):
    rng = np.random.default_rng(3)
    B, S, P = 3, 9, 300  # odd S, P not a multiple of 128
    vals = _vals(rng, (B, S, P), dtype)
    first = rng.random((S, P)) < 0.15
    first[:, 0] = True
    _check_scan(vals, first, red)


@pytest.mark.parametrize("red", ["sum", "max"])
def test_segscan_multi_chunk_carry(red):
    """Segments spanning several 128-lane chunks exercise the carry path."""
    rng = np.random.default_rng(5)
    B, S, P = 2, 8, 640
    vals = rng.integers(0, 10, (B, S, P)).astype(np.int32)
    first = np.zeros((S, P), bool)
    first[:, 0] = True
    for s in range(S):
        first[s, rng.integers(1, P)] = True
    _check_scan(vals, first, red)


def test_segscan_row_without_leading_flag():
    """A row whose lane 0 is not flagged still starts a segment there."""
    rng = np.random.default_rng(6)
    vals = rng.integers(-5, 5, (2, 3, 200)).astype(np.int32)
    first = rng.random((3, 200)) < 0.1
    first[:, 0] = False
    _check_scan(vals, first, "sum")


def test_cpu_calls_leave_launch_counters_at_zero():
    gather.LAUNCHES.reset()
    segscan.LAUNCHES.reset()
    v = torch.arange(24, dtype=torch.int32).reshape(1, 2, 12)
    gather.gather_rows(v, torch.zeros((2, 12), dtype=torch.int32))
    segscan.segmented_scan(v, torch.ones((2, 12), dtype=torch.bool), "sum")
    assert gather.LAUNCHES.value == 0 and segscan.LAUNCHES.value == 0

