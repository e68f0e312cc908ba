"""The HSTU cell (benchmark/serve_hstu.py) at a tiny size on the CPU: a run
through the harness, `correct`'s comparison (the program within the
limits, the control and a planted fault past them), and the reference's
own planted faults."""
from __future__ import annotations

import json
import time
import types

import numpy as np
import pytest
import torch

from benchmark import control_hstu, harness
from benchmark.reference import hstu as ref_hstu
from benchmark.tests.bench_tiny import tiny

CELL = "hstu-passb"


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run(trace):
    spec, cfg, traffic = tiny(CELL)
    out = harness.run_cell(CELL, 2**31 + 9, 1.0, bool(trace), time.perf_counter(),
                           device="cpu", spec=spec, cfg=cfg, traffic=traffic,
                           log=lambda *a: None)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["lists_compared"]["value"] > 0
    if trace:
        # a CPU run has no device trace: the device readers, and the span
        # readers that wait for one, find nothing
        assert set(out["metrics"]) <= {"runner.wait_share.serve"}
    else:
        assert set(out["metrics"]) == {"sessions_per_s", "setup_s"}
    json.dumps(out)


def test_control_fails_where_the_program_passes():
    spec, cfg, traffic = tiny(CELL)
    r = control_hstu.readings(CELL, 3, 1, "cpu", cfg, traffic)
    assert r["program"]["bad_lists"] == 0 and r["program"]["lists"] > 0
    lim = cfg["correct"]
    for key in ("max_gap", "gapped_share"):
        if lim.get(key) is not None:
            assert r["program"][key] <= lim[key]
    assert any(lim.get(k) is not None and r["control"][k] > lim[k]
               for k in ("max_gap", "gapped_share"))


def test_altered_lists_are_not_correct(monkeypatch):
    from otto_tpu_torch.engine import rank

    orig = rank.score_topk_multi

    def altered(b, rankers, top_k=20):
        out = orig(b, rankers, top_k)
        out[:, :, [0, 1]] = out[:, :, [1, 0]]   # the first two of every list swapped
        return out
    monkeypatch.setattr(rank, "score_topk_multi", altered)
    spec, cfg, traffic = tiny(CELL)
    out = harness.run_cell(CELL, 5, 0.2, False, time.perf_counter(), device="cpu",
                           spec=spec, cfg=cfg, traffic=traffic, log=lambda *a: None)
    assert out["correct"] is False
    c = out["checks"]
    assert {k for k, v in c.items() if v["limit"] is not None
            and v["value"] > v["limit"]} & {"max_gap", "gapped_share"}


@pytest.mark.parametrize("precision,fault", [("low", ""), ("full", "no_bias"),
                                             ("full", "softmax")])
def test_reference_faults_move_the_scores(precision, fault):
    """Each planted fault of the reference moves a session's scores (at the
    cell's widths and depth) by more than twice the cell's max_gap limit."""
    from benchmark import serve_hstu

    _, cfg, _ = tiny(CELL)
    cfg = dict(cfg, n_aids=200)
    p = serve_hstu.hstu_weights(cfg, 104, 7, "cpu")
    g = np.random.default_rng(0)
    aid, ts, typ = g.integers(0, 200, 9), np.cumsum(g.integers(1, 5000, 9)), g.integers(0, 3, 9)
    cand = g.choice(200, 40, replace=False)
    feats = torch.from_numpy(g.exponential(3.0, (40, 104)).astype(np.float32))
    h = types.SimpleNamespace(**cfg["hstu"])
    full = ref_hstu.session_scores(p, h, aid, ts, typ, cand, feats)
    got = ref_hstu.session_scores(p, h, aid, ts, typ, cand, feats, precision, fault)
    assert (got - full).abs().max() > 2 * cfg["correct"]["max_gap"]
