"""The whole serving slice against otto_tpu: retrieval -> scoring with three
GBDT rankers -> top-20 -> submission file -> recall@20.

The reference side runs otto_tpu's own Pipeline._score_pass and
_submit_and_eval (on a Pipeline built without its work-dir set-up, which
would also switch on jax's persistent compile cache); the port runs
otto_tpu_torch.pipeline.runner's score_pass and submit_and_eval on the CPU.

The seeded rankers split only on integer-valued features, which the port
reproduces bit for bit, so the float-feature tolerance of
test_torch_retrieval.py cannot flip a bin; their leaf values are dyadic, so
scores are exact in any summation order.
"""
import functools

import numpy as np

from otto_tpu.config import TYPES, Config, GBDTConfig
from otto_tpu.engine import rank as ref_rank
from otto_tpu.engine.retrieval import FEATURE_INDEX, FEATURE_NAMES
from otto_tpu.models.gbdt import GBDTRanker as RefGBDT
from otto_tpu.models.gbdt import compute_bin_edges
from otto_tpu.pipeline.runner import Pipeline
from otto_tpu_torch import convert
from otto_tpu_torch.data.schema import Labels as PortLabels
from otto_tpu_torch.engine import rank as port_rank
from otto_tpu_torch.pipeline import runner as port_runner
from test_torch_retrieval import BATCH, CFG, FLOAT_FEATURES, build_world

SPLIT_FEATURES = np.array(
    [FEATURE_INDEX[n] for n in FEATURE_NAMES if n not in FLOAT_FEATURES]
)


def seeded_rankers(feats: np.ndarray) -> dict:
    """Three otto_tpu rankers with seeded trees over bins fitted to the
    retrieved features."""
    cfg = GBDTConfig(n_trees=40, max_depth=4, n_bins=16)
    edges = compute_bin_edges(feats, cfg.n_bins, seed=0)
    out = {}
    for i, tname in enumerate(TYPES):
        rng = np.random.default_rng(100 + i)
        shape = (cfg.n_trees, cfg.max_depth, 2 ** (cfg.max_depth - 1))
        out[tname] = RefGBDT(
            cfg=cfg,
            edges=edges,
            gfeat=rng.choice(SPLIT_FEATURES, shape).astype(np.int32),
            thr=rng.integers(1, cfg.n_bins, shape).astype(np.int32),
            leaf=(rng.integers(-128, 128, (cfg.n_trees, 2 ** cfg.max_depth))
                  / 32.0).astype(np.float32),
            feature_names=FEATURE_NAMES,
        )
    return out


def _ref_pipeline(work_dir) -> Pipeline:
    pipe = object.__new__(Pipeline)
    pipe.cfg = Config(retrieval=CFG)
    pipe.work_dir = str(work_dir)
    pipe.stage_log = []
    return pipe


@functools.lru_cache(maxsize=None)
def run_slice(tmp_root):
    w = build_world()
    sp = w["split"]
    sample = [np.asarray(b.feats) for b in w["ref"].iter_run(sp.test, BATCH)]
    flat = np.concatenate([f.reshape(-1, f.shape[-1]) for f in sample])
    ref_rankers = seeded_rankers(flat[flat[:, FEATURE_INDEX["src_any"]] > 0])

    ref_dir = tmp_root / "ref"
    ref_dir.mkdir()
    pipe = _ref_pipeline(ref_dir)
    ref_preds = pipe._score_pass(w["ref"], sp.test, ref_rankers, BATCH)
    ref_metrics = pipe._submit_and_eval(ref_preds, sp.labels, {}, 0.0)

    port_dir = tmp_root / "port"
    port_dir.mkdir()
    for t, r in ref_rankers.items():
        r.save(str(port_dir / f"ranker-gbdt-{t}.npz"))
    port_rankers = port_runner.load_rankers(str(port_dir))
    assert all(
        np.array_equal(port_rankers[t].leaf, convert.gbdt_from_numpy(r).leaf)
        for t, r in ref_rankers.items()
    )
    port_preds = port_runner.score_pass(w["port"], w["port_test"], port_rankers, BATCH)
    lab = sp.labels
    port_metrics = port_runner.submit_and_eval(
        str(port_dir), port_preds, PortLabels(lab.session, lab.type, lab.aid))
    return {
        "ref": (ref_preds, ref_metrics, ref_dir),
        "port": (port_preds, port_metrics, port_dir),
        "n_test": len(np.unique(sp.test.session)),
    }


def _run(tmp_path_factory):
    return run_slice(tmp_path_factory.getbasetemp())


def test_top20_equal(tmp_path_factory):
    r = _run(tmp_path_factory)
    ref_preds, port_preds = r["ref"][0], r["port"][0]
    for t in TYPES:
        np.testing.assert_array_equal(port_preds[t][0], ref_preds[t][0])
        assert port_preds[t][1].shape == (r["n_test"], 20)
        np.testing.assert_array_equal(port_preds[t][1], ref_preds[t][1])
    # the rankers are not trivial: the three targets rank differently
    assert not np.array_equal(port_preds["clicks"][1], port_preds["orders"][1])


def test_recall_equal(tmp_path_factory):
    r = _run(tmp_path_factory)
    ref_m, port_m = r["ref"][1], r["port"][1]
    assert set(port_m) == {"clicks", "carts", "orders", "total"}
    for k in port_m:
        assert abs(port_m[k] - ref_m[k]) <= 1e-12, k
    assert port_m["total"] > 0


def test_score_and_topk_equal():
    """The per-ranker scorer, on the retrieved batches of both packages."""
    w = build_world()
    ref_batches = list(w["ref"].iter_run(w["split"].test, BATCH))
    flat = np.concatenate(
        [np.asarray(b.feats).reshape(-1, len(FEATURE_NAMES)) for b in ref_batches])
    ranker = seeded_rankers(flat)["carts"]
    want = ref_rank.score_and_topk(ref_batches, ranker)
    got = port_rank.score_and_topk(
        list(w["port"].iter_run(w["port_test"], BATCH)), convert.gbdt_from_numpy(ranker))
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


def test_submission_file_equal(tmp_path_factory):
    r = _run(tmp_path_factory)
    ref_csv = (r["ref"][2] / "submission.csv").read_bytes()
    port_csv = (r["port"][2] / "submission.csv").read_bytes()
    assert port_csv == ref_csv
    assert (r["port"][2] / "eval_submission.json").exists()
