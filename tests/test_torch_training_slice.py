"""The training slice against otto_tpu: events -> tables -> pass A (label
join, per-source eval, downsampling) -> three GBDT rankers -> pass B ->
recall@20.

otto_tpu's Pipeline.run_streaming runs once on tests/test_pipeline.py's
tiny configuration and data (2,500 sessions, 1,200 aids, 20 trees at depth
3); the port's run_streaming runs on the CPU under the config.json that
otto_tpu stored, with what the port cannot make the same way: otto_tpu's
word2vec models (its `w2v-*.npz`, given by the config's model names),
otto_tpu's k-means++ start (test_torch_build.py says why) and otto_tpu's
threefry GBDT draws (test_torch_gbdt_train.py's hook).

Held equal: the retrieval reports and metrics; the persisted pass-A rows'
labels, sessions and every integer-valued feature (float16 bytes); the
trees as functions of the rows (every row reaches the same leaf of every
tree; leaves within TRAIN_LEAF_TOL); recall@20.

What is not bit-equal, and why. Three of retrieval's float features reach
the rows within FLOAT_TOL of otto_tpu's, not bit for bit (test_torch_
retrieval.py holds them in float32): dist_w2vec_* averages kNN distances,
whose self-distance is otto_tpu's exact 0 but the port's 2s - q^2 - c^2,
an ulp off; cos_sim_ses_aid can round to the next float16; and
eucl_dist_ses_aid is the square root of a float32 cancellation where a
session's embedding nearly equals a candidate's, so near 0 it differs by
up to the root of that rounding. The bin edges of such a feature may then
differ, and so may a split feature: where two features split the rows
identically (n_w2vec_all > 0 and dist_w2vec_all >= a tiny edge), otto_tpu
picks whichever gain its float32 sums round higher, while the port's exact
sums tie and it takes the first. Such a tree sends every row to the same
leaf; the test checks exactly that.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.config import (
    Config,
    CoVisConfig,
    GBDTConfig,
    KMeansConfig,
    RankerConfig,
    RetrievalConfig,
    Word2VecConfig,
)
from otto_tpu.data.split import split_events
from otto_tpu.data.synthetic import SyntheticSpec, generate
from otto_tpu.engine.retrieval import FEATURE_NAMES
from otto_tpu.models.gbdt import GBDTRanker as RefGBDT
from otto_tpu.models.word2vec import Word2Vec as RefWord2Vec
from otto_tpu.ops import kmeans as ref_kmeans
from otto_tpu.pipeline.runner import Pipeline
from otto_tpu_torch import config as port_config
from otto_tpu_torch import convert
from otto_tpu_torch.data.schema import Events, Labels
from otto_tpu_torch.models import gbdt as port_gbdt
from otto_tpu_torch.ops import kmeans as port_kmeans
from otto_tpu_torch.pipeline import runner as port_runner
from test_torch_gbdt_train import TRAIN_LEAF_TOL, ref_draws

TYPES = ("clicks", "carts", "orders")
SPEC = SyntheticSpec(n_sessions=2500, n_aids=1200, mean_len=10, span_days=21, seed=11)
BATCH = 64
W2V = dict(
    wall=Word2VecConfig(name="wall", types=(0, 1, 2), vector_size=16, window=4,
                        min_count=2, epochs=2, batch_size=4096, knn_k=10,
                        knn_first_n_aids=800),
    w12=Word2VecConfig(name="w12", types=(1, 2), vector_size=16, window=4,
                       min_count=2, epochs=1, batch_size=4096, knn_k=10,
                       knn_first_n_aids=800),
)
RETRIEVAL = dict(max_session_aids=16, max_candidates=128, session_len_buckets=(8, 32))
GBDT = dict(n_trees=20, max_depth=3, n_bins=16, colsample=0.5, subsample=0.8,
            min_child_samples=5, max_group=64, row_chunk=4096, group_chunk=256)
CFG = Config(
    covis=dataclasses.replace(CoVisConfig(), accumulator_capacity=1 << 17),
    retrieval=RetrievalConfig(**RETRIEVAL),
    w2vec=W2V,
    kmeans=dataclasses.replace(KMeansConfig(), max_iter=10),
    ranker=RankerConfig(hidden_dims=(32, 16), epochs=3, batch_sessions=64,
                        max_group=64, learning_rate=3e-3),
    gbdt=GBDTConfig(**GBDT),
)


@functools.lru_cache(maxsize=None)
def run_both(tmp_root):
    sp = split_events(generate(SPEC), CFG.data.test_days, CFG.data.seed)
    ref_dir = str(tmp_root / "ref")
    ref_metrics = Pipeline(cfg=CFG, work_dir=ref_dir, n_aids=SPEC.n_aids).run_streaming(
        sp.train, sp.test, sp.labels, batch_sessions=BATCH)

    models = {n: convert.word2vec_from_numpy(RefWord2Vec.load(
        os.path.join(ref_dir, f"w2v-{n}.npz"), c)) for n, c in W2V.items()}
    sess_emb = np.load(os.path.join(ref_dir, "session_emb.npz"))["emb"]
    n_clusters = CFG.kmeans.n_clusters_to_find[0]
    assert len(sess_emb) < 1 << 16           # k-means++ seeded on every session
    _, kinit = jax.random.split(jax.random.PRNGKey(CFG.kmeans.seed))
    init = np.array(ref_kmeans._kmeanspp_init_device(jnp.asarray(sess_emb), n_clusters, kinit))

    def ev(e):
        return Events(e.session, e.aid, e.ts, e.type)

    port_dir = tmp_root / "port"
    port_dir.mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_kmeans, "init_centroids",
                   lambda x, k, sample, generator: torch.from_numpy(init))
        mp.setattr(port_gbdt, "tree_draws", lambda cfg, f, n, device: ref_draws(cfg, f, n))
        lab = sp.labels
        port_metrics = port_runner.run_streaming(
            ev(sp.train), ev(sp.test), Labels(lab.session, lab.type, lab.aid),
            SPEC.n_aids, str(port_dir), "cpu", cfg=port_cfg(ref_dir), models=models,
            batch_sessions=BATCH)
    return {"ref": (ref_metrics, ref_dir), "port": (port_metrics, str(port_dir)), "split": sp}


def port_cfg(ref_dir):
    """CFG as the port reads it from the config.json otto_tpu stored."""
    return port_config.config_from_json(os.path.join(ref_dir, "config.json"))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return run_both(tmp_path_factory.getbasetemp())


# float features of the rows against otto_tpu's: one float16 ulp (2^-10
# relative), or this absolute difference near 0
F16_ULP = 2.0 ** -10
FLOAT_TOL = {"dist_w2vec_all": 1e-5, "dist_w2vec_1_2": 1e-5,
             "cos_sim_ses_aid": 0.0, "eucl_dist_ses_aid": 4e-3}


def _rows(work_dir, tname):
    return np.load(os.path.join(work_dir, f"downsampled-{tname}.npz"))


@pytest.mark.parametrize("tname", TYPES)
def test_downsampled_rows_equal(both, tname):
    (_, ref_dir), (_, port_dir) = both["ref"], both["port"]
    want, got = _rows(ref_dir, tname), _rows(port_dir, tname)
    assert got["feats"].dtype == np.float16 and got["y"].dtype == np.int8
    for k in ("y", "session"):
        np.testing.assert_array_equal(got[k], want[k])
    assert 0 < got["y"].sum() < len(got["y"])
    for j, name in enumerate(FEATURE_NAMES):
        g, w = got["feats"][:, j], want["feats"][:, j]
        if name not in FLOAT_TOL:
            assert g.tobytes() == w.tobytes(), name
            continue
        d = np.abs(g.astype(np.float64) - w)
        tol = np.maximum(FLOAT_TOL[name], F16_ULP * np.abs(w.astype(np.float64)))
        assert (d <= tol).all(), (name, d.max())
        assert (d > 0).mean() < 0.05, name


def test_retrieval_reports_and_ceiling_equal(both):
    (ref_m, ref_dir), (port_m, port_dir) = both["ref"], both["port"]
    for name in ("eval_retrieved.json", "eval_retrieved_sources.json", "passA-metrics.json"):
        with open(os.path.join(ref_dir, name)) as a, open(os.path.join(port_dir, name)) as b:
            assert json.load(b) == json.load(a), name
    for k in ("ceiling_clicks", "ceiling_carts", "ceiling_orders", "ceiling_total",
              "cand_per_session_mean", "cand_per_session_min", "cand_per_session_max"):
        assert port_m[k] == ref_m[k], k
    assert 0 < port_m["ceiling_total"] < 1


def leaf_of(model, rows):
    """[N, T]: the leaf each row reaches in each tree."""
    bins = port_gbdt.bin_features(rows, model.edges)
    T, D, _ = model.gfeat.shape
    tree = np.arange(T)[None, :]
    node = np.zeros((len(rows), T), np.int64)
    for level in range(D):
        f = model.gfeat[tree, level, node]
        b = np.take_along_axis(bins, f.astype(np.int64), axis=1)
        node = node * 2 + (b >= model.thr[tree, level, node])
    return node


@pytest.mark.parametrize("tname", TYPES)
def test_trees_equal(both, tname):
    (_, ref_dir), (_, port_dir) = both["ref"], both["port"]
    want = RefGBDT.load(os.path.join(ref_dir, f"ranker-gbdt-{tname}.npz"))
    got = port_gbdt.GBDTRanker.load(os.path.join(port_dir, f"ranker-gbdt-{tname}.npz"))
    np.testing.assert_array_equal(got.thr, want.thr)
    # the same partition of the rows at every node of every tree
    np.testing.assert_array_equal(leaf_of(got, _rows(port_dir, tname)["feats"]),
                                  leaf_of(want, _rows(ref_dir, tname)["feats"]))
    differ = got.gfeat != want.gfeat
    assert differ.mean() < 0.05
    np.testing.assert_allclose(got.gains[differ], want.gains[differ], rtol=1e-5)
    np.testing.assert_allclose(got.leaf, want.leaf, atol=TRAIN_LEAF_TOL)
    assert got.best_iter == want.best_iter == 20
    assert abs(got.best_score - want.best_score) <= 1e-4
    imp = os.path.join(port_dir, f"feat-importance-{tname}.csv")
    assert open(imp).readline() == "feature,gain_importance\n"


def test_recall_equal(both):
    (ref_m, _), (port_m, port_dir) = both["ref"], both["port"]
    for k in ("clicks", "carts", "orders", "total"):
        assert port_m[k] == ref_m[k], (k, port_m[k], ref_m[k])
    assert port_m["total"] > 0.2
    assert os.path.exists(os.path.join(port_dir, "submission.csv"))


def test_resume_skips_pass_a_and_serves_without_labels(both, tmp_path):
    """The crash-resume fast path: with pass A's metrics and rows (one
    ranker already trained) in the work dir, run_streaming trains the
    missing rankers from the rows, and an unlabelled run serves from the
    rankers alone."""
    import shutil

    (_, port_dir), sp = both["port"], both["split"]
    cfg = port_cfg(both["ref"][1])
    work = tmp_path / "resume"
    shutil.copytree(port_dir, work)
    for t in ("carts", "orders"):
        os.remove(work / f"ranker-gbdt-{t}.npz")
    os.remove(work / "downsampled-clicks.npz")
    calls = []
    orig = port_runner.pass_a
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_runner, "pass_a", lambda *a, **k: calls.append(1) or orig(*a, **k))
        mp.setattr(port_gbdt, "tree_draws", lambda cfg, f, n, device: ref_draws(cfg, f, n))
        retriever = "unused"
        mp.setattr(port_runner, "build_retriever",
                   lambda *a, **k: (retriever, None))
        mp.setattr(port_runner, "score_pass", lambda r, test, rankers, b: {
            t: (np.array([1], np.int32), np.zeros((1, 20), np.int32)) for t in rankers})
        lab = sp.labels
        m = port_runner.run_streaming(
            None, None, Labels(lab.session, lab.type, lab.aid), SPEC.n_aids, str(work),
            "cpu", cfg=cfg, batch_sessions=BATCH)
        assert not calls and m["ceiling_total"] == both["port"][0]["ceiling_total"]
        for t in ("carts", "orders"):
            np.testing.assert_array_equal(
                port_gbdt.GBDTRanker.load(str(work / f"ranker-gbdt-{t}.npz")).thr,
                port_gbdt.GBDTRanker.load(os.path.join(port_dir, f"ranker-gbdt-{t}.npz")).thr)
        assert port_runner.run_streaming(None, None, None, SPEC.n_aids, str(work),
                                         "cpu", cfg=cfg) == {}
    with pytest.raises(NotImplementedError, match="MLP ranker is not ported"):
        port_runner.run_streaming(None, None, None, SPEC.n_aids, str(work), "cpu",
                                  cfg=dataclasses.replace(cfg, ranker_backend="mlp"))
