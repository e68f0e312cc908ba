"""K4, the session embeddings and the kNN tables against otto_tpu.

- K4's twin against otto_tpu's `gather_rows_hbm` in interpret mode:
  bit-equal (a row copy).
- `session_embedding_batch` against otto_tpu's: within 1e-6 relative +
  1e-7 absolute. The weighted sum runs through torch's einsum here and
  XLA's dot there, both float32, in other orders.
- `compute_session_embeddings`: session ids equal; embeddings within one
  float16 ulp, because both round each result to float16 and a sum that
  differs in its last float32 bits may round to the neighbouring float16.
- `build_knn_tables` on seeded models carried across by
  `convert.word2vec_from_numpy`: neighbours equal, distances within 1e-5
  relative + 1e-4 absolute. The two sides write the l2 score differently
  (test_torch_knn.py); a word's distance to itself cancels terms
  |q|^2 + |c|^2 of ~30 down to ~0, which leaves a few float32 ulps of
  those terms (~1e-5) as the absolute difference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.config import Word2VecConfig as RefW2VConfig
from otto_tpu.data import batching as ref_batching
from otto_tpu.data.synthetic import SyntheticSpec, generate
from otto_tpu.engine import session_embed as ref_se
from otto_tpu.models.word2vec import Word2Vec as RefWord2Vec
from otto_tpu.models.word2vec import build_vocab as ref_build_vocab
from otto_tpu.ops.pallas.dma_gather import gather_rows_hbm
from otto_tpu_torch import convert
from otto_tpu_torch.data import batching
from otto_tpu_torch.data.schema import Events
from otto_tpu_torch.engine import session_embed as se
from otto_tpu_torch.ops.kernels import dma_gather

N_AIDS = 500


def f16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of float16 values at |x| (2^-24 below the normal range)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0**-14)))
    return 2.0 ** (e - 10)


def assert_within_f16_ulp(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = f16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= ulp), float(np.max(np.abs(got - want) / ulp))


# the cases of tests/test_dma_gather.py, and ids outside [0, V) that both
# clamp: (V, D, N, block_n, dtype, id range)
GATHER_CASES = [
    pytest.param(1000, 128, 300, 64, np.float32, (0, 1000), id="f32"),
    pytest.param(256, 128, 128, 32, np.int32, (0, 256), id="int32"),
    pytest.param(50, 100, 77, 32, np.float32, (-20, 80), id="clamped-d100"),
]


@pytest.mark.parametrize("V,D,N,block_n,dtype,id_range", GATHER_CASES)
def test_gather_twin_matches_pallas_interpret(V, D, N, block_n, dtype, id_range):
    rng = np.random.default_rng(V)
    if dtype == np.int32:
        tab = rng.integers(-5, 5, (V, D)).astype(np.int32)
    else:
        tab = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(*id_range, N).astype(np.int32)
    want = np.asarray(gather_rows_hbm(jnp.asarray(tab), jnp.asarray(ids), block_n, True))
    dma_gather.LAUNCHES.reset()
    got = dma_gather.gather_rows_hbm(torch.from_numpy(tab), torch.from_numpy(ids))
    assert dma_gather.LAUNCHES.value == 0        # a CPU tensor runs the twin
    assert got.dtype == torch.from_numpy(tab).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_refuses_bad_input():
    tab = torch.zeros((4, 3))
    with pytest.raises(TypeError):
        dma_gather.gather_rows_hbm(tab, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(TypeError):
        dma_gather.gather_rows_hbm(tab.double(), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(IndexError):
        dma_gather.gather_rows_hbm(torch.zeros((0, 3)), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        dma_gather.gather_rows_hbm(tab.to("meta"), torch.zeros(2, dtype=torch.int32, device="meta"))


@pytest.fixture(scope="module")
def events():
    ev = generate(SyntheticSpec(n_sessions=700, n_aids=N_AIDS, max_len=150,
                                mean_len=12, span_days=21, seed=7))
    return ev, Events(ev.session, ev.aid, ev.ts, ev.type)


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(8)
    t = rng.normal(size=(N_AIDS, 24)).astype(np.float32)
    t[rng.random(N_AIDS) < 0.1] = 0.0     # aids without an embedding
    return t


def test_session_embedding_batch_matches_reference(events, table):
    ref_ev, ev = events
    for w, g in zip(ref_batching.pack_sessions(ref_ev), batching.pack_sessions(ev)):
        want = np.asarray(ref_se.session_embedding_batch(
            jnp.asarray(w.aid), jnp.asarray(w.ts), jnp.asarray(w.type),
            jnp.asarray(table)))
        got = se.session_embedding_batch(
            torch.from_numpy(g.aid), torch.from_numpy(g.ts), torch.from_numpy(g.type),
            torch.from_numpy(table))
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("lane_budget", [1 << 19, 200])
def test_compute_session_embeddings_matches_reference(events, table, lane_budget):
    """The small lane budget cuts every bucket into several microbatches,
    the last one padded."""
    ref_ev, ev = events
    want_s, want_e = ref_se.compute_session_embeddings(
        ref_batching.pack_sessions(ref_ev), table, lane_budget=lane_budget)
    got_s, got_e = se.compute_session_embeddings(
        batching.pack_sessions(ev), torch.from_numpy(table), lane_budget=lane_budget)
    np.testing.assert_array_equal(got_s, want_s)
    assert got_e.shape == want_e.shape and got_e.dtype == torch.float32
    assert_within_f16_ulp(got_e.numpy(), want_e)
    # the results are float16 values
    assert torch.equal(got_e, got_e.half().float())


def _models(events, first_n):
    ref_ev, _ = events
    rng = np.random.default_rng(9)
    out = {}
    for name, types in (("w2v-all", (0, 1, 2)), ("w2v-1-2", (1, 2))):
        cfg = RefW2VConfig(name=name, types=types, vector_size=16, min_count=2,
                           knn_k=20, knn_first_n_aids=first_n)
        vocab = ref_build_vocab(ref_ev, types, cfg.min_count, N_AIDS)
        emb = rng.normal(size=(vocab.size, 16)).astype(np.float32)
        out[name] = RefWord2Vec(cfg, vocab, emb)
    return out


@pytest.mark.parametrize("first_n", [100, 10_000])
def test_build_knn_tables_matches_reference(events, first_n):
    for name, ref_model in _models(events, first_n).items():
        want = ref_se.build_knn_tables(ref_model, N_AIDS)
        model = convert.word2vec_from_numpy(ref_model)
        assert model.cfg.knn_first_n_aids == first_n
        got = se.build_knn_tables(model, N_AIDS, "cpu")
        assert got.neighbor.dtype == torch.int32 and got.dist.dtype == torch.float32
        np.testing.assert_array_equal(got.neighbor.numpy(), want.neighbor)
        np.testing.assert_allclose(got.dist.numpy(), want.dist, rtol=1e-5, atol=1e-4)
        n_rows = int((got.neighbor[:, 0] >= 0).sum())
        assert n_rows == min(first_n, model.vocab.size), name
