"""scripts/run_fullscale_torch.py on the CPU at the training slice's tiny
configuration and data (2,500 sessions): its record, a second call on the
same work dir (events read back, pass A skipped), the metrics of the
port's run_streaming on the same events, and --report. The first call
places the events and tables in a directory of their own (the
OTTO_FS_TMPFS knob), the second runs without the knob on the links it
left, and a third runs fresh without the knob in a work dir of its own
from a copy of the first's events."""
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
    out = {"tmpfs": root / "shm", "work": work, "cfg": cfg}
    with two_threads():
        for name, tmpfs in (("first", str(out["tmpfs"])), ("second", None)):
            path = root / f"{name}.json"
            ret = fs.run(spec, str(work), str(path), batch=BATCH, device="cpu", cfg=cfg,
                         tmpfs=tmpfs)
            with open(path) as fh:
                out[name] = json.load(fh)
            assert out[name]["metrics"] == ret["metrics"]
            out[f"{name}_path"] = path
        out["plain_work"] = root / "plain"
        out["plain_work"].mkdir()
        shutil.copy(work / "events.npz", out["plain_work"])
        out["plain"] = fs.run(spec, str(out["plain_work"]), str(root / "plain.json"),
                              batch=BATCH, device="cpu", cfg=cfg)
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


def test_tmpfs_placement(runs):
    """The events and the seven tables are written into the tmpfs dir and
    linked from the work dir; the rows, rankers and reports stay in the
    work dir; every stage records the bytes on disk, in the tmpfs dir and
    written, and at the end they add up to the files there."""
    work, tmpfs = runs["work"], runs["tmpfs"]
    names = fs.tmpfs_names(runs["cfg"])
    assert len(names) == 8 and "events.npz" in names
    assert sorted(p.name for p in tmpfs.iterdir()) == sorted(names)
    for name in names:
        link = work / name
        assert link.is_symlink() and link.resolve() == (tmpfs / name).resolve(), name
    for name in ("downsampled-clicks.npz", "ranker-gbdt-orders.npz", "submission.csv",
                 "passA-metrics.json", "eval_retrieved_sources.json"):
        assert (work / name).is_file() and not (work / name).is_symlink(), name
    rec = runs["first"]
    assert rec["tmpfs"] == str(tmpfs) and rec["host"]["df_h_tmpfs"]
    stages = rec["stages"]
    for s in stages:
        assert {"disk_bytes", "tmpfs_bytes", "write_bytes"} <= set(s), s["stage"]
        assert s["tmpfs_bytes"] > 0 and s["write_bytes"] >= 0
    # the work dir holds only links until the pipeline writes config.json
    assert stages[0]["disk_bytes"] == 0 and all(s["disk_bytes"] > 0 for s in stages[2:])
    assert all(a["write_bytes"] <= b["write_bytes"] for a, b in zip(stages, stages[1:]))
    files = [p for p in work.rglob("*") if p.is_file()]
    disk = sum(p.stat().st_size for p in files if not p.is_symlink())
    linked = sum(p.stat().st_size for p in files if p.is_symlink())
    assert stages[0]["tmpfs_bytes"] == (tmpfs / "events.npz").stat().st_size
    assert stages[-1]["tmpfs_bytes"] == linked == sum(p.stat().st_size for p in tmpfs.iterdir())
    # the second call (no knob) wrote the work dir's last files
    last = runs["second"]["stages"][-1]
    assert stages[-1]["disk_bytes"] <= last["disk_bytes"] == disk
    assert last["tmpfs_bytes"] is None


def test_fresh_run_without_knob_writes_the_same_files(runs):
    """The script's default placement, fresh: every file in the work dir,
    the same tables, submission and metrics as the run with the knob."""
    rec, work = runs["plain"], runs["plain_work"]
    assert rec["generator"] == "cache" and rec["tmpfs"] is None
    assert [s["stage"] for s in rec["stages"]] == ["generate", "split"] + PIPELINE_STAGES
    assert rec["metrics"] == runs["first"]["metrics"]
    assert not any(p.is_symlink() for p in work.iterdir())
    for name in fs.tmpfs_names(runs["cfg"]) + ["submission.csv"]:
        a, b = work / name, runs["work"] / name
        if name.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files), name
                for k in za.files:
                    np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{name}:{k}")
        else:
            assert a.read_bytes() == b.read_bytes(), name


def test_placement_refuses_another_runs_files(tmp_path):
    """A tmpfs dir serves one work dir: a work dir that links nothing there
    refuses a dir holding files, no link is made to a file that the work
    dir did not link, a link into another dir is refused, and cached
    events that do not fit the spec are refused."""
    names = ["events.npz", "covis.pkl"]
    shm, a, b = tmp_path / "shm", tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    fs.place_in_tmpfs(str(a), str(shm), names)
    (shm / "covis.pkl").write_bytes(b"x")
    fs.place_in_tmpfs(str(a), str(shm), names)          # a resume
    with pytest.raises(FileExistsError, match="another run"):
        fs.place_in_tmpfs(str(b), str(shm), names)
    (a / "events.npz").unlink()
    (shm / "events.npz").write_bytes(b"y")
    with pytest.raises(FileExistsError, match="not written through"):
        fs.place_in_tmpfs(str(a), str(shm), names)
    with pytest.raises(ValueError, match="not a file in"):
        fs.place_in_tmpfs(str(a), str(tmp_path / "other"), names)
    assert sorted(p.name for p in b.iterdir()) == []
    spec = SyntheticSpec(n_sessions=3, n_aids=5)
    ev = Events(np.array([0, 1, 2], np.int32), np.array([4, 0, 1], np.int32),
                np.zeros(3, np.int32), np.zeros(3, np.int8))
    fs.check_events(ev, spec)
    for bad in (dataclasses.replace(spec, n_sessions=4), dataclasses.replace(spec, n_aids=4)):
        with pytest.raises(ValueError, match="cached events"):
            fs.check_events(ev, bad)


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
