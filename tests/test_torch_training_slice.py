"""The training slice against otto_tpu: events -> tables -> pass A (label
join, per-source eval, downsampling) -> three GBDT rankers -> pass B ->
recall@20.

otto_tpu's Pipeline.run_streaming runs once on tests/test_pipeline.py's
tiny configuration and data (2,500 sessions, 1,200 aids, 20 trees at depth
3); the port's Pipeline.run_streaming runs on the CPU under the
config.json that otto_tpu stored (both Pipelines' stage logs are kept),
with what the port cannot make the same way: otto_tpu's
word2vec models (its `w2v-*.npz`, copied into the port's work dir and
read from the port's artifact cache),
otto_tpu's k-means++ start (test_torch_build.py says why) and otto_tpu's
threefry GBDT draws (test_torch_gbdt_train.py's hook).

The port's batch runner (Pipeline.run) then runs on copies of both work
dirs, every table and ranker read from the cache: on otto_tpu's it gives
otto_tpu's ceiling, per-source report and recall, on the port's its own
streaming run's (otto_tpu's test_streaming_runner_matches_batch), and
otto_tpu's build reads the port's cache files.

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
import contextlib
import dataclasses
import functools
import json
import os
import pickle
import shutil

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
from otto_tpu.ops import kmeans as ref_kmeans
from otto_tpu.pipeline.runner import Pipeline
from otto_tpu_torch import config as port_config
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
    ref_pipe = Pipeline(cfg=CFG, work_dir=ref_dir, n_aids=SPEC.n_aids)
    ref_metrics = ref_pipe.run_streaming(sp.train, sp.test, sp.labels, batch_sessions=BATCH)

    sess_emb = np.load(os.path.join(ref_dir, "session_emb.npz"))["emb"]
    n_clusters = CFG.kmeans.n_clusters_to_find[0]
    assert len(sess_emb) < 1 << 16           # k-means++ seeded on every session
    _, kinit = jax.random.split(jax.random.PRNGKey(CFG.kmeans.seed))
    init = np.array(ref_kmeans._kmeanspp_init_device(jnp.asarray(sess_emb), n_clusters, kinit))

    def ev(e):
        return Events(e.session, e.aid, e.ts, e.type)

    port_dir = tmp_root / "port"
    port_dir.mkdir()
    # otto_tpu's word2vec models reach the port through its artifact cache
    for n in W2V:
        shutil.copy(os.path.join(ref_dir, f"w2v-{n}.npz"), port_dir)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_kmeans, "init_centroids",
                   lambda x, k, sample, generator: torch.from_numpy(init))
        mp.setattr(port_gbdt, "tree_draws", lambda cfg, f, n, device: ref_draws(cfg, f, n))
        lab = sp.labels
        port_pipe = port_runner.Pipeline(port_cfg(ref_dir), str(port_dir), SPEC.n_aids,
                                         device="cpu")
        port_metrics = port_pipe.run_streaming(
            ev(sp.train), ev(sp.test), Labels(lab.session, lab.type, lab.aid),
            batch_sessions=BATCH)
    return {"ref": (ref_metrics, ref_dir), "port": (port_metrics, str(port_dir)), "split": sp,
            "stage_log": (ref_pipe.stage_log, port_pipe.stage_log)}


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


def test_stage_log_matches_reference(both):
    """The port's Pipeline.run_streaming logs otto_tpu's stages, by name and
    in order, each entry as it ends with its seconds and host RSS."""
    ref_log, port_log = both["stage_log"]
    names = [e["stage"] for e in port_log]
    assert names == [e["stage"] for e in ref_log]
    assert names[0] == "covis" and names[-1] == "eval"
    assert "retrieve+downsample (pass A)" in names and "score (pass B)" in names
    for e in port_log:
        assert e["rss_gb"] > 0 and e["elapsed_s"] >= 0, e
        assert "peak_mem_gb" not in e   # a CPU run measures no device memory
    assert [e["elapsed_s"] for e in port_log] == sorted(e["elapsed_s"] for e in port_log)
    msgs = {e["stage"]: e.get("msg") for e in port_log}
    assert msgs["eval_retrieved"] == dict((e["stage"], e.get("msg")) for e in ref_log)[
        "eval_retrieved"]
    for t in TYPES:
        n = len(_rows(both["port"][1], t)["y"])
        assert msgs[f"downsample {t} persisted"] == f"{n} rows"


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
        pipe = port_runner.Pipeline(cfg, str(work), SPEC.n_aids, device="cpu")
        m = pipe.run_streaming(None, None, Labels(lab.session, lab.type, lab.aid),
                               batch_sessions=BATCH)
        assert not calls and m["ceiling_total"] == both["port"][0]["ceiling_total"]
        # otto_tpu's resumed run: the missing rankers, then its cached-pass-A entry
        assert [e["stage"] for e in pipe.stage_log] == [
            "ranker carts (gbdt)", "ranker orders (gbdt)", "pass A + rankers (cached)",
            "score (pass B)", "submit", "eval"]
        assert all(e["rss_gb"] > 0 for e in pipe.stage_log)
        for t in ("carts", "orders"):
            np.testing.assert_array_equal(
                port_gbdt.GBDTRanker.load(str(work / f"ranker-gbdt-{t}.npz")).thr,
                port_gbdt.GBDTRanker.load(os.path.join(port_dir, f"ranker-gbdt-{t}.npz")).thr)
        assert port_runner.run_streaming(None, None, None, SPEC.n_aids, str(work),
                                         "cpu", cfg=cfg) == {}


# ---------------------------------------------------------------------------
# the MLP ranker (ranker_backend="mlp") on copies of both work dirs
# ---------------------------------------------------------------------------
MLP_CFG = CFG.replace(ranker_backend="mlp")
# a score's tolerance (tests/test_torch_ranker.py): about two bfloat16 ulps
SCORE_RTOL, SCORE_ATOL = 2.0 ** -6, 1e-3


def _mlp_work_dir(src, dst, port):
    """A copy of a work dir with pass A's metrics and rows and no ranker,
    its config.json rewritten for MLP_CFG by the package that reads it."""
    from otto_tpu.config import config_to_json as ref_config_to_json

    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("ranker-*", "feat-importance-*",
                                                           "submission.csv"))
    if port:
        port_config.config_to_json(
            dataclasses.replace(port_cfg(src), ranker_backend="mlp"), str(dst / "config.json"))
    else:
        ref_config_to_json(MLP_CFG, str(dst / "config.json"))
    return dst


def inject_ref_init(mp):
    """The port's towers start from otto_tpu's initial params (threefry)."""
    from otto_tpu.models import ranker as ref_ranker
    from otto_tpu_torch import convert
    from otto_tpu_torch.models import ranker as port_ranker

    def init(n_features, cfg, mean, std, seed=None, src_idx=None):
        return convert.ranker_from_numpy(
            ref_ranker.init_ranker(n_features, MLP_CFG.ranker, mean, std, seed, src_idx))

    mp.setattr(port_ranker, "init_ranker", init)


@pytest.fixture(scope="module")
def mlp_runs(both, tmp_path_factory):
    """run_streaming with ranker_backend="mlp" through the crash-resume
    path (pass A's metrics and rows cached, no ranker): otto_tpu's Pipeline
    on a copy of its work dir trains its towers and serves them; the port
    then serves otto_tpu's towers from a copy of that dir, and trains its
    own, from otto_tpu's initial params, on a copy of its own work dir."""
    sp = both["split"]
    root = tmp_path_factory.mktemp("mlp")
    ref_work = _mlp_work_dir(both["ref"][1], root / "ref", port=False)
    rows = {f: os.stat(ref_work / f).st_mtime_ns for f in os.listdir(ref_work)
            if f.startswith("downsampled-")}
    ref_m = Pipeline(cfg=MLP_CFG, work_dir=str(ref_work), n_aids=SPEC.n_aids
                     ).run_streaming(sp.train, sp.test, sp.labels, batch_sessions=BATCH)
    assert rows == {f: os.stat(ref_work / f).st_mtime_ns for f in rows}   # no pass A
    train, test, labels = _port_split(sp)
    serve_work = root / "serve"
    shutil.copytree(ref_work, serve_work)
    os.remove(serve_work / "submission.csv")
    cfg = port_cfg(str(serve_work))
    assert cfg.ranker_backend == "mlp" and cfg.ranker.hidden_dims == (32, 16)
    own_work = _mlp_work_dir(both["port"][1], root / "port", port=True)
    calls = []
    with one_thread(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_runner, "pass_a", lambda *a, **k: calls.append(1))
        served = port_runner.run_streaming(train, test, labels, SPEC.n_aids, str(serve_work),
                                           "cpu", cfg=cfg, batch_sessions=BATCH)
        inject_ref_init(mp)
        own = port_runner.run_streaming(train, test, labels, SPEC.n_aids, str(own_work),
                                        "cpu", cfg=cfg, batch_sessions=BATCH)
    assert not calls, "pass A ran: the crash-resume path was not taken"
    return {"ref": (ref_m, ref_work), "served": (served, serve_work), "own": (own, own_work),
            "split": sp}


def test_mlp_serving_from_reference_towers(mlp_runs):
    """The port's top-20 from otto_tpu's own ranker-mlp-*.npz (read, not
    retrained) equals otto_tpu's, but where the 20th and 21st scores lie
    within a score's tolerance."""
    from otto_tpu_torch.engine import rank as rank_engine

    (_, ref_work), (got_m, work) = mlp_runs["ref"], mlp_runs["served"]
    for t in TYPES:
        assert (open(work / f"ranker-mlp-{t}.npz", "rb").read()
                == open(ref_work / f"ranker-mlp-{t}.npz", "rb").read())
    want = rank_engine.read_submission(str(ref_work / "submission.csv"))
    got = rank_engine.read_submission(str(work / "submission.csv"))
    cfg = port_cfg(str(work))
    train, test, _ = _port_split(mlp_runs["split"])
    with one_thread():
        retriever, _ = port_runner.build_retriever(
            train, test, SPEC.n_aids, "cpu", cfg.w2vec, None, cfg.covis, cfg.popularity,
            cfg.retrieval, cfg.kmeans, cache_dir=str(work))
        batches = retriever.run(test, batch_sessions=BATCH)
    rankers = port_runner.load_rankers(str(work), cfg)
    n_diff = 0
    for t in TYPES:
        assert got[t].keys() == want[t].keys()
        sess, _, scores = rank_engine.score_and_topk(batches, rankers[t], top_k=21)
        s20, s21 = dict(zip(sess, scores[:, 19])), dict(zip(sess, scores[:, 20]))
        for s in want[t]:
            if set(got[t][s]) == set(want[t][s]):
                continue
            n_diff += 1
            assert abs(s20[s] - s21[s]) <= SCORE_RTOL * abs(s20[s]) + SCORE_ATOL, (t, s)
    assert n_diff <= 0.02 * sum(len(want[t]) for t in TYPES), n_diff
    for k in ("clicks", "carts", "orders", "total"):
        assert abs(got_m[k] - mlp_runs["ref"][0][k]) <= 0.01, k


def test_mlp_trained_in_the_port(mlp_runs):
    """The port's own towers, trained from its rows and otto_tpu's initial
    params: otto_tpu's `.npz` layout, and recall@20 within 0.01 of
    otto_tpu's towers'."""
    (want, ref_work), (got, work) = mlp_runs["ref"], mlp_runs["own"]
    for t in TYPES:
        z, zr = np.load(work / f"ranker-mlp-{t}.npz"), np.load(ref_work / f"ranker-mlp-{t}.npz")
        assert sorted(z.files) == sorted(zr.files)
        assert [z[f"w{i}"].shape for i in range(3)] == [(104, 32), (32, 16), (16, 1)]
        assert not (work / f"feat-importance-{t}.csv").exists()
    for k in ("clicks", "carts", "orders", "total"):
        assert abs(got[k] - want[k]) <= 0.01, (k, got[k], want[k])
    assert got["total"] > 0.2


# ---------------------------------------------------------------------------
# the batch runner and the artifact cache, on copies of both work dirs
# ---------------------------------------------------------------------------
def close(x, y, tol, path=""):
    """Two reports equal: the same keys, numbers within tol."""
    if isinstance(x, dict):
        assert isinstance(y, dict) and set(x) == set(y), (path, set(x) ^ set(y))
        for k in x:
            close(x[k], y[k], tol, f"{path}/{k}")
    else:
        assert abs(x - y) <= tol, (path, x, y)


def _port_split(sp):
    lab = sp.labels
    return (Events(sp.train.session, sp.train.aid, sp.train.ts, sp.train.type),
            Events(sp.test.session, sp.test.aid, sp.test.ts, sp.test.type),
            Labels(lab.session, lab.type, lab.aid))


@contextlib.contextmanager
def one_thread():
    """One intra-op thread: these runs are thousands of small ops, where a
    thread pool contending with other test processes only adds waits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def batch_runs(both, tmp_path_factory):
    """Pipeline.run (labelled, then unlabelled) on a copy of the port's work
    dir and (labelled) on a copy of otto_tpu's; every table and ranker
    must come from the cache."""
    with one_thread():
        return _batch_runs(both, tmp_path_factory)


def _batch_runs(both, tmp_path_factory):
    cfg = port_cfg(both["ref"][1])
    train, test, labels = _port_split(both["split"])
    out = {}
    for name, (_, src) in (("port", both["port"]), ("ref", both["ref"])):
        work = tmp_path_factory.mktemp(f"batch_{name}")
        shutil.copytree(src, work, dirs_exist_ok=True)
        rankers = {t: os.stat(work / f"ranker-gbdt-{t}.npz").st_mtime_ns for t in TYPES}
        pipe = port_runner.Pipeline(cfg, str(work), SPEC.n_aids, device="cpu")
        metrics = pipe.run(train, test, labels, batch_sessions=BATCH)
        assert len(pipe.build_report.cache["loaded"]) == 7, pipe.build_report.cache
        assert not pipe.build_report.cache["written"]
        assert rankers == {t: os.stat(work / f"ranker-gbdt-{t}.npz").st_mtime_ns
                           for t in TYPES}
        out[name] = (metrics, work, (work / "submission.csv").read_text())
        if name == "port":
            assert pipe.run(train, test, None, batch_sessions=BATCH) == {}
            out["rank"] = (work / "submission.csv").read_text()
    return out


def test_batch_runner_on_reference_work_dir(both, batch_runs):
    """The port's Pipeline.run on otto_tpu's tables and rankers: otto_tpu's
    ceiling and per-source report (host eval against otto_tpu's device
    eval, within 1e-9) and recall@20 (exactly)."""
    (ref_m, ref_dir), (got, work, _) = both["ref"], batch_runs["ref"]
    for name in ("eval_retrieved.json", "eval_retrieved_sources.json"):
        with open(os.path.join(ref_dir, name)) as a, open(work / name) as b:
            close(json.load(b), json.load(a), 1e-9, name)
    for k in ("ceiling_clicks", "ceiling_carts", "ceiling_orders", "ceiling_total"):
        assert abs(got[k] - ref_m[k]) <= 1e-9, k
    for k in ("clicks", "carts", "orders", "total"):
        assert got[k] == ref_m[k], (k, got[k], ref_m[k])


def test_batch_runner_matches_streaming(both, batch_runs):
    """otto_tpu's test_streaming_runner_matches_batch on the port: the batch
    runner (host C14 eval, score_and_topk in turn) against the streaming run
    (device C14 eval, overlapped score_pass) on the same work dir: metrics
    and reports within 1e-9, the same submission; the unlabelled run (the
    CLI's rank) writes that submission too."""
    (stream_m, port_dir), (got, work, sub) = both["port"], batch_runs["port"]
    for k, v in got.items():
        assert abs(v - stream_m[k]) <= 1e-9, (k, v, stream_m[k])
    for name in ("eval_retrieved.json", "eval_retrieved_sources.json"):
        with open(os.path.join(port_dir, name)) as a, open(work / name) as b:
            close(json.load(b), json.load(a), 1e-9, name)
    want = open(os.path.join(port_dir, "submission.csv")).read()
    assert sub == want and batch_runs["rank"] == want
    assert len(want.splitlines()) == 1 + 3 * len(np.unique(both["split"].test.session))


def test_reference_reads_the_port_cache(both, tmp_path):
    """otto_tpu's build_retriever on a copy of the port's work dir reads
    every cached artifact and serves from the port's arrays: its tables
    equal the port's."""
    from otto_tpu.config import config_to_json as ref_config_to_json

    (_, port_dir), sp = both["port"], both["split"]
    work = tmp_path / "ref_reads_port"
    shutil.copytree(port_dir, work)
    ref_config_to_json(CFG, str(work / "config.json"))   # otto_tpu's own guard
    with open(os.path.join(port_dir, "covis.pkl"), "rb") as fh:
        stored = pickle.load(fh)
    assert all(type(v) is tuple and all(type(a) is np.ndarray for a in v)
               for v in stored.values())
    mtimes = {f: os.stat(work / f).st_mtime_ns for f in os.listdir(work)
              if f.endswith((".npz", ".pkl"))}
    ref = Pipeline(cfg=CFG, work_dir=str(work), n_aids=SPEC.n_aids).build_retriever(
        sp.train, sp.test)
    assert mtimes == {f: os.stat(work / f).st_mtime_ns for f in mtimes}
    train, test, _ = _port_split(sp)
    with one_thread():
        port = port_runner.Pipeline(port_cfg(both["ref"][1]), str(work), SPEC.n_aids,
                                    device="cpu").build_retriever(train, test)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref.ctx)]
    got = [t.numpy() for t in port.ctx.tensors()]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    for f in ("ids", "cluster", "emb"):
        np.testing.assert_array_equal(getattr(port.sessions, f), getattr(ref.sessions, f))


def test_pass_a_overlapped_equals_sequential(both, tmp_path):
    """The streaming run's pass A (overlapped: consumer thread) against
    pass A in turn on one thread, from the same cached tables: rows
    (float16 bytes), labels, sessions, reports and metrics bit-equal."""
    (_, port_dir), sp = both["port"], both["split"]
    train, test, labels = _port_split(sp)
    cfg = port_cfg(both["ref"][1])
    with one_thread():
        retriever, _ = port_runner.build_retriever(
            train, test, SPEC.n_aids, "cpu", cfg.w2vec, None, cfg.covis, cfg.popularity,
            cfg.retrieval, cfg.kmeans, cache_dir=port_dir)
        _, rep = port_runner.pass_a(retriever, test, labels, cfg.ranker, str(tmp_path),
                                    BATCH, overlap=False)
    assert rep.phases["waiting for the consumer"] == 0.0
    for name in ("eval_retrieved.json", "eval_retrieved_sources.json", "passA-metrics.json"):
        assert (tmp_path / name).read_text() == open(os.path.join(port_dir, name)).read()
    for t in TYPES:
        got, want = np.load(tmp_path / f"downsampled-{t}.npz"), _rows(port_dir, t)
        for k in ("feats", "y", "session"):
            assert got[k].tobytes() == want[k].tobytes(), (t, k)
