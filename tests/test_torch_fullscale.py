"""scripts/run_fullscale_torch.py on the CPU at the training slice's tiny
configuration and data (2,500 sessions): its record, a second call on the
same work dir (events read back, pass A skipped), the metrics of the
port's run_streaming on the same events, and --report."""
import contextlib
import dataclasses
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from otto_tpu.config import config_to_json as ref_config_to_json
from otto_tpu_torch import config as port_config
from otto_tpu_torch.data.schema import Events
from otto_tpu_torch.data.split import split_events
from otto_tpu_torch.data.synthetic import SyntheticSpec
from otto_tpu_torch.pipeline import runner as port_runner
from test_torch_training_slice import BATCH, CFG, SPEC

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import run_fullscale_torch as fs  # noqa: E402

PIPELINE_STAGES = [
    "covis", "w2vec wall", "w2vec w12", "session_emb", "kmeans", "popularity",
    "context built", "retrieve+downsample (pass A)", "eval_retrieved", "eval per-source",
    "downsample clicks persisted", "downsample carts persisted",
    "downsample orders persisted", "ranker clicks (gbdt)", "ranker carts (gbdt)",
    "ranker orders (gbdt)", "score (pass B)", "submit", "eval"]
RESUMED_STAGES = PIPELINE_STAGES[:7] + ["pass A + rankers (cached)"] + PIPELINE_STAGES[-3:]


@contextlib.contextmanager
def two_threads():
    """Two intra-op threads: retrieval's batches halve their time on two,
    and more only contend with the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fullscale")
    ref_config_to_json(CFG, str(root / "config.json"))
    cfg = port_config.config_from_json(str(root / "config.json"))
    spec = SyntheticSpec(**dataclasses.asdict(SPEC))
    work = root / "work"
    out = {}
    with two_threads():
        for name in ("first", "second"):
            path = root / f"{name}.json"
            ret = fs.run(spec, str(work), str(path), batch=BATCH, device="cpu", cfg=cfg)
            with open(path) as fh:
                out[name] = json.load(fh)
            assert out[name]["metrics"] == ret["metrics"]
            out[f"{name}_path"] = path
        # the same events through the port's run_streaming, in a work dir of its
        # own that holds the script's co-visitation tables (counting them
        # again would double the test's time; every later stage runs anew)
        z = np.load(work / "events.npz")
        sp = split_events(Events(z["session"], z["aid"], z["ts"], z["type"]),
                          cfg.data.test_days, cfg.data.seed)
        (root / "direct").mkdir()
        shutil.copy(work / "covis.pkl", root / "direct")
        out["direct"] = port_runner.run_streaming(
            sp.train, sp.test, sp.labels, SPEC.n_aids, str(root / "direct"), "cpu",
            cfg=cfg.replace(ranker=dataclasses.replace(cfg.ranker, device_select=True)),
            batch_sessions=BATCH)
        out["n_test_sessions"] = len(np.unique(sp.test.session))
    return out


def test_record_schema(runs):
    rec = runs["first"]
    for k in ("spec", "reference_eta_s", "stages", "generator", "n_events", "n_train_events",
              "n_test_sessions", "metrics", "pipeline_s", "total_s", "device", "host",
              "reduced", "per_source"):
        assert k in rec, k
    assert rec["spec"] == {"n_sessions": 2500, "n_aids": 1200, "mean_len": 10,
                           "max_len": 64, "batch_sessions": BATCH}
    assert rec["device"] == {"type": "cpu", "name": "cpu"}
    assert rec["generator"] == "device"
    assert rec["n_test_sessions"] == runs["n_test_sessions"]
    assert 0 < rec["n_train_events"] < rec["n_events"]
    assert {r["knob"] for r in rec["reduced"]} == {"n_sessions", "n_aids", "mean_len",
                                                    "max_len"}
    stages = rec["stages"]
    assert [s["stage"] for s in stages] == ["generate", "split"] + PIPELINE_STAGES
    for s in stages[2:]:
        assert s["rss_gb"] > 0 and s["delta_s"] >= 0, s
    assert abs(sum(s["delta_s"] for s in stages[2:]) - stages[-1]["elapsed_s"]) < 1e-2
    assert rec["total_s"] >= rec["pipeline_s"] >= stages[-1]["elapsed_s"]
    assert "src_any" in rec["per_source"]
    assert set(rec["metrics"]) == {
        "ceiling_clicks", "ceiling_carts", "ceiling_orders", "ceiling_total",
        "cand_per_session_mean", "cand_per_session_min", "cand_per_session_max",
        "clicks", "carts", "orders", "total"}


def test_metrics_equal_run_streaming(runs):
    assert runs["first"]["metrics"] == runs["direct"]
    assert 0 < runs["direct"]["total"] <= runs["direct"]["ceiling_total"]


def test_second_call_reads_events_and_skips_pass_a(runs):
    rec = runs["second"]
    assert rec["generator"] == "cache"
    assert rec["n_events"] == runs["first"]["n_events"]
    assert [s["stage"] for s in rec["stages"]] == ["generate", "split"] + RESUMED_STAGES
    assert rec["metrics"] == runs["first"]["metrics"]


def test_report_renders_both_tables(runs, capsys):
    assert fs.main(["--report", str(runs["first_path"])]) == 0
    text = capsys.readouterr().out
    assert "| Stage | s | host RSS GiB | peak device GiB |" in text
    assert "| Stage | reference (CPU box) | otto_tpu_torch (cpu) |" in text
    assert "| covis | 50 min |" in text and "| rankers | 10 min |" in text
    assert "| ranked recall@20 total |" in text and "0.566174" in text
    assert "candidates/session mean / min / max" in text and "172.4 / 56 / 2322" in text
    assert "src_any" in text


def test_no_quiet_cpu_path(tmp_path):
    """The run is on the card unless the caller names the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fs.run(SyntheticSpec(n_sessions=10, n_aids=10), str(tmp_path / "w"),
               str(tmp_path / "r.json"))
    assert not (tmp_path / "r.json").exists()
