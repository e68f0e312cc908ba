"""The harness on the CPU at a tiny size: the result line's keys, the
files found by name, BENCHMARK.json's form, the refusals, and no module of
JAX or of the JAX package loaded by a run."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.tests.bench_tiny import tiny

ROOT = Path(__file__).resolve().parents[2]
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(trace):
    spec, cfg, traffic = tiny("gbdt-nearline", n_trees=8)
    out = harness.run_cell("gbdt-nearline", 2**31 + 5, 4.0, bool(trace), time.perf_counter(),
                           device="cpu", spec=spec, cfg=cfg, traffic=traffic,
                           log=lambda *a: None)
    want = LINE_KEYS[:-1] + (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == want
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    if trace:
        # a CPU run has no device trace: the device readers find nothing
        assert set(out["metrics"]) <= {"runner.wait_share.nearline"}
    else:
        assert set(out["metrics"]) == {"request_p90_ms", "setup_s"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_every_file_found_by_name():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        cell, cfg, traffic = harness.find_cell(spec, w["name"])
        assert cfg["name"] == cell["config"]
        assert (ROOT / "benchmark" / f"{traffic['driver']}.py").exists()
    for m in spec["per_layer"]:
        r = harness.load_reader(m["name"])
        suffix = m["name"].rsplit(".", 1)[1]
        assert r.LAYER == m["layer"] and r.UNIT == m["unit"]
        assert r.MOVES[suffix] == m["moves"]
        assert r.read({}) is None


def test_benchmark_json_form():
    spec = harness.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith("benchmark/")
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        got = harness.metrics_of(spec, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
        layer = harness.metrics_of(spec, w["name"], "per_layer")
        assert layer and all(m["moves"] in {g["name"] for g in got} for m in layer)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert m["better"] in ("lower", "higher") and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$",
                                                             m["unit"])
    assert len(json.dumps(spec)) < 64 * 1024


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, **(env or {})))


def test_refuses_without_a_card():
    p = _run(["--workload", "gbdt-passb", "--seed", "1", "--seconds", "1", "--trace", "0"],
             ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_refuses_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["--workload", "gbdt-passb", "--seed", "1", "--seconds", "1", "--trace", "0"],
             tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_loads_no_jax():
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark import harness\n"
        "from benchmark.tests.bench_tiny import tiny\n"
        "spec, cfg, traffic = tiny('mlp-passb')\n"
        "out = harness.run_cell('mlp-passb', 7, 0.1, True, time.perf_counter(), device='cpu',"
        " spec=spec, cfg=cfg, traffic=traffic, log=lambda *a: None)\n"
        "assert out['correct']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "otto_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")


@pytest.mark.cuda
def test_tiny_cell_on_the_card(card):
    spec, cfg, traffic = tiny("gbdt-passb")
    out = harness.run_cell("gbdt-passb", 11, 0.5, True, time.perf_counter(), device="cuda",
                           spec=spec, cfg=cfg, traffic=traffic, log=lambda *a: None)
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
