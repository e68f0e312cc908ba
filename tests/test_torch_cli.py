"""The port's command line (otto_tpu_torch.pipeline.cli) on the CPU: synth
-> split -> run-synthetic --tiny --device cpu -> rank --device cpu on the
same work dir (rank reads every artifact from the cache and writes the
same submission), ingest of OTTO JSONL, and the device default: without
--device the CLI runs on the card, so on a machine without one it
raises instead of running on the CPU."""
import argparse
import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from otto_tpu.data.schema import Events as RefEvents
from otto_tpu.data.split import split_events as ref_split_events
from otto_tpu.data.synthetic import SyntheticSpec as RefSpec
from otto_tpu.data.synthetic import generate as ref_generate
from otto_tpu_torch.data.schema import Events, Labels
from otto_tpu_torch.data import split
from otto_tpu_torch.pipeline import cli, runner
import torch_threads  # noqa: F401

SMALL = ["--sessions", "400", "--aids", "300", "--seed", "7"]


@pytest.fixture(autouse=True)
def keep_logging():
    """cli.main reconfigures the root logger (stderr and the work dir's
    logs.log); put it back after each test."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in root.handlers:
        if h not in handlers:
            h.close()
    root.handlers[:], root.level = handlers, level


def test_synth_split_run_synthetic_then_rank(tmp_path, capsys):
    ev_path, prefix, work = tmp_path / "events.parquet", str(tmp_path / "sp"), tmp_path / "work"
    assert cli.main(["synth", *SMALL, "--out", str(ev_path)]) == 0
    # otto_tpu's generator, draw for draw, and its reader of the file
    want = ref_generate(RefSpec(n_sessions=400, n_aids=300, seed=7))
    got = RefEvents.from_parquet(str(ev_path))
    for c in ("session", "aid", "ts", "type"):
        np.testing.assert_array_equal(getattr(got, c), getattr(want, c))
    assert cli.main(["split", "--events", str(ev_path), "--out-prefix", prefix]) == 0
    ref_sp = ref_split_events(want, 7, 42)
    np.testing.assert_array_equal(Labels.from_parquet(prefix + "-labels.parquet").aid,
                                  ref_sp.labels.aid)

    capsys.readouterr()
    assert cli.main(["run-synthetic", "--tiny", "--device", "cpu", *SMALL, "--work-dir",
                     str(work), "--batch-sessions", "64"]) == 0
    metrics = json.loads(capsys.readouterr().out)
    assert all(0.0 < metrics[k] <= 1.0 for k in ("clicks", "carts", "orders", "total"))
    assert metrics["ceiling_total"] >= metrics["total"]
    sub = (work / "submission.csv").read_text()
    artifacts = {f: os.stat(work / f).st_mtime_ns for f in os.listdir(work)
                 if f.endswith((".npz", ".pkl"))}
    assert len(artifacts) == 10                # 7 tables' files and 3 rankers

    os.remove(work / "submission.csv")
    assert cli.main(["rank", "--train", prefix + "-train.parquet", "--test",
                     prefix + "-test.parquet", "--work-dir", str(work), "--device", "cpu",
                     "--batch-sessions", "64"]) == 0
    assert (work / "submission.csv").read_text() == sub
    assert artifacts == {f: os.stat(work / f).st_mtime_ns for f in artifacts}

    # the streaming runner on the same tables, its rankers trained from pass
    # A's rows, gives the batch runner's metrics (trained from downsample)
    stream = tmp_path / "stream"
    shutil.copytree(work, stream, ignore=shutil.ignore_patterns("ranker-*"))
    sp = split.split_events(Events.from_parquet(str(ev_path)), 7, 42)
    got = runner.Pipeline(cli.tiny_config(), str(stream), 300, device="cpu").run_streaming(
        sp.train, sp.test, sp.labels, batch_sessions=64)
    for k, v in metrics.items():
        assert abs(got[k] - v) <= 1e-9, (k, got[k], v)


def test_mlp_backend_run_synthetic_then_rank(tmp_path, capsys):
    """--ranker-backend mlp: run-synthetic trains and serves three MLP
    towers (otto_tpu's tiny tower); rank reads the backend from the work
    dir's config.json and serves the same towers from the cache."""
    ev_path, prefix, work = tmp_path / "events.parquet", str(tmp_path / "sp"), tmp_path / "work"
    assert cli.main(["synth", *SMALL, "--out", str(ev_path)]) == 0
    assert cli.main(["split", "--events", str(ev_path), "--out-prefix", prefix]) == 0
    capsys.readouterr()
    assert cli.main(["run-synthetic", "--tiny", "--device", "cpu", "--ranker-backend", "mlp",
                     *SMALL, "--work-dir", str(work), "--batch-sessions", "64"]) == 0
    metrics = json.loads(capsys.readouterr().out)
    assert 0.0 < metrics["total"] <= metrics["ceiling_total"]
    stored = json.load(open(work / "config.json"))
    assert stored["ranker_backend"] == "mlp" and stored["ranker"]["hidden_dims"] == [32, 16]
    towers = {f: os.stat(work / f).st_mtime_ns for f in os.listdir(work)
              if f.startswith("ranker-")}
    assert sorted(towers) == [f"ranker-mlp-{t}.npz" for t in ("carts", "clicks", "orders")]
    sub = (work / "submission.csv").read_text()
    os.remove(work / "submission.csv")
    assert cli.main(["rank", "--train", prefix + "-train.parquet", "--test",
                     prefix + "-test.parquet", "--work-dir", str(work), "--device", "cpu",
                     "--batch-sessions", "64"]) == 0
    assert (work / "submission.csv").read_text() == sub
    assert towers == {f: os.stat(work / f).st_mtime_ns for f in towers}


def test_ingest_jsonl(tmp_path):
    """OTTO JSONL -> parquet: the events and labels come back equal."""
    want = ref_generate(RefSpec(n_sessions=60, n_aids=200, seed=3))
    names = ("clicks", "carts", "orders")
    lines = []
    for s in np.unique(want.session):
        m = want.session == s
        lines.append(json.dumps({"session": int(s), "events": [
            {"aid": int(a), "ts": int(t) * 1000 + 1_600_000_000_000, "type": names[y]}
            for a, t, y in zip(want.aid[m], want.ts[m], want.type[m])]}))
    (tmp_path / "s.jsonl").write_text("\n".join(lines) + "\n")
    (tmp_path / "l.jsonl").write_text(
        json.dumps({"session": 5, "labels": {"clicks": 9, "orders": [1, 2]}}) + "\n")
    prefix = str(tmp_path / "in")
    assert cli.main(["ingest", "--sessions-jsonl", str(tmp_path / "s.jsonl"),
                     "--labels-jsonl", str(tmp_path / "l.jsonl"), "--out-prefix", prefix]) == 0
    got = Events.from_parquet(prefix + "-events.parquet")
    np.testing.assert_array_equal(got.session, want.session)
    np.testing.assert_array_equal(got.aid, want.aid)
    np.testing.assert_array_equal(got.type, want.type)
    np.testing.assert_array_equal(got.ts, want.ts + 1_600_000_000)
    lab = Labels.from_parquet(prefix + "-labels.parquet")
    assert sorted(zip(lab.session.tolist(), lab.type.tolist(), lab.aid.tolist())) == \
        [(5, 0, 9), (5, 2, 1), (5, 2, 2)]


def test_device_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["run-synthetic", "--tiny", "--sessions", "50", "--work-dir",
                  str(tmp_path / "w")])
    assert not (tmp_path / "w" / "config.json").exists()


@pytest.mark.parametrize("mesh,ok", [("data=1", True), ("data=1,model=1", True),
                                     ("data=2", False), ("data=1,model=2", False)])
def test_mesh_names_one_device_only(mesh, ok):
    """In one process (no torchrun) a 1x1 mesh runs unsharded; a larger one
    raises, naming the world size (tests/test_torch_pipeline_mesh.py runs
    the ranks)."""
    args = argparse.Namespace(mesh=mesh, device="cpu")
    if ok:
        assert cli.build_mesh(args) is None
    else:
        with pytest.raises(ValueError, match="the world size is 1"):
            cli.build_mesh(args)
    with pytest.raises(ValueError):
        cli.parse_mesh_spec("rows=2")
