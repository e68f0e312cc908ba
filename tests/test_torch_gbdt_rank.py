"""GBDT scoring, top-k selection and the submission file: otto_tpu_torch
against otto_tpu.models.gbdt / otto_tpu.engine.rank."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.config import GBDTConfig
from otto_tpu.engine import rank as ref_rank
from otto_tpu.models.gbdt import GBDTRanker as RefGBDT
from otto_tpu_torch import convert
from otto_tpu_torch.engine import rank as port_rank
from otto_tpu_torch.engine.retrieval import FEATURE_NAMES
from otto_tpu_torch.models.gbdt import GBDTRanker

F = len(FEATURE_NAMES)


def seeded_ranker(seed, n_trees=12, depth=4, n_bins=16) -> RefGBDT:
    """A reference ranker with seeded trees. Leaf values are dyadic
    (multiples of 1/64 below 4), so the sum over trees is exact in any
    order and scores can be compared bit for bit."""
    rng = np.random.default_rng(seed)
    cfg = GBDTConfig(n_trees=n_trees, max_depth=depth, n_bins=n_bins)
    edges = np.sort(rng.normal(size=(F, n_bins - 1)), axis=1).astype(np.float32)
    edges[rng.random(F) < 0.1, -3:] = np.inf          # collapsed quantiles
    W = 2 ** (depth - 1)
    return RefGBDT(
        cfg=cfg,
        edges=edges,
        gfeat=rng.integers(0, F, (n_trees, depth, W)).astype(np.int32),
        # n_bins = a no-op split (every row goes left)
        thr=rng.integers(1, n_bins + 1, (n_trees, depth, W)).astype(np.int32),
        leaf=(rng.integers(-256, 256, (n_trees, 2 ** depth)) / 64.0).astype(np.float32),
        feature_names=FEATURE_NAMES,
        gains=rng.random((n_trees, depth, W)).astype(np.float32),
        best_iter=n_trees,
        best_score=0.5,
    )


def _feats(seed, ref, shape=(9, 33)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape + (F,)).astype(np.float32)
    # values exactly on bin edges: x >= edge must count the edge
    on_edge = rng.random(shape + (F,)) < 0.2
    e = ref.edges[np.arange(F), rng.integers(0, ref.edges.shape[1], F)]
    return np.where(on_edge & np.isfinite(e), e, x).astype(np.float32)


def test_load_reads_reference_npz(tmp_path):
    ref = seeded_ranker(1)
    path = str(tmp_path / "ranker-gbdt-clicks.npz")
    ref.save(path)
    got = GBDTRanker.load(path)
    for field in ("n_trees", "max_depth", "n_bins"):
        assert getattr(got.cfg, field) == getattr(ref.cfg, field)
    assert got.feature_names == ref.feature_names
    for name in ("edges", "gfeat", "thr", "leaf", "gains"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert got.best_iter == ref.best_iter and got.best_score == ref.best_score


BAD_RANKERS = {
    "feature_names": lambda r: setattr(
        r, "feature_names", tuple(f"f{i}" for i in range(F))),
    "gfeat_high": lambda r: r.gfeat.__setitem__((0, 0, 0), F),
    "gfeat_negative": lambda r: r.gfeat.__setitem__((1, 2, 3), -1),
    "thr_zero": lambda r: r.thr.__setitem__((0, 1, 0), 0),
    "thr_high": lambda r: r.thr.__setitem__((2, 0, 1), r.cfg.n_bins + 1),
    "edges_shape": lambda r: setattr(r, "edges", r.edges[:-1]),
    "leaf_shape": lambda r: setattr(r, "leaf", r.leaf[:, :-1]),
}


@pytest.mark.parametrize("fault", sorted(BAD_RANKERS))
def test_load_rejects_a_bad_ranker(tmp_path, fault):
    """A ranker saved for other features, or corrupt, is refused at load
    (and when carried across) instead of reaching K1, which reads the
    split features' bins without a bound check."""
    ref = seeded_ranker(7)
    BAD_RANKERS[fault](ref)
    path = str(tmp_path / "bad.npz")
    ref.save(path)
    with pytest.raises(ValueError):
        GBDTRanker.load(path)
    with pytest.raises(ValueError):
        convert.gbdt_from_numpy(ref)


@pytest.mark.parametrize("seed", [2, 3])
def test_scores_equal_reference(seed):
    ref = seeded_ranker(seed)
    x = _feats(seed, ref)
    want = np.asarray(ref.predict_scores_device(jnp.asarray(x)))
    got = convert.gbdt_from_numpy(ref).predict_scores_device(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_scores_default_config_shape():
    """The production tree shape: 150 trees, depth 4, 64 bins."""
    ref = seeded_ranker(4, n_trees=150, depth=4, n_bins=64)
    x = _feats(4, ref, shape=(3, 40))
    want = np.asarray(ref.predict_scores_device(jnp.asarray(x)))
    got = convert.gbdt_from_numpy(ref).predict_scores_device(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_topk_ties_follow_lax_top_k():
    rng = np.random.default_rng(5)
    Sn, Cn, k = 16, 64, 20
    scores = rng.integers(0, 4, (Sn, Cn)).astype(np.float32)   # heavy ties
    cand = rng.integers(-1, 500, (Sn, Cn)).astype(np.int32)
    cand[0, 5:] = -1                                            # < k valid
    ws, wa = ref_rank._topk_program(jnp.asarray(scores), jnp.asarray(cand), k)
    gs, ga = port_rank._topk_program(
        torch.from_numpy(scores), torch.from_numpy(cand), k)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_submission_bytes_match_reference(tmp_path):
    rng = np.random.default_rng(6)
    preds = {}
    for t in ("clicks", "carts", "orders"):
        sessions = rng.permutation(40).astype(np.int32)
        aids = rng.integers(-1, 10_000, (40, 20)).astype(np.int32)
        preds[t] = (sessions, aids)
    want, got = tmp_path / "ref.csv", tmp_path / "port.csv"
    ref_rank.write_submission(str(want), preds)
    port_rank.write_submission(str(got), preds)
    assert got.read_bytes() == want.read_bytes()
    assert port_rank.read_submission(str(got)) == ref_rank.read_submission(str(want))
