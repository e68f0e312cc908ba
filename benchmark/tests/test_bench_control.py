"""`correct`'s comparison at a tiny size on the CPU: the program reads no
gap, the control (the reference at the precision below the
configuration's) reads a gap past the limit, and a run whose timed path
is broken underneath comes out not correct, once for each fault a
serving cell can have: an answer altered where it is produced, and half
of each batch's sessions left out."""
from __future__ import annotations

import time

import numpy as np
import pytest

from benchmark import control, harness
from benchmark.tests.bench_tiny import tiny


@pytest.mark.parametrize("workload", ["gbdt-passb", "mlp-passb"])
def test_control_fails_where_the_program_passes(workload):
    spec, cfg, traffic = tiny(workload)
    r = control.readings(workload, 3, 1, "cpu", cfg, traffic)
    assert r["program"]["bad_lists"] == 0 and r["program"]["lists"] > 0
    lim = cfg["correct"]
    for key in ("max_gap", "gapped_share"):
        if lim.get(key) is not None:
            assert r["program"][key] <= lim[key]
    assert any(lim.get(k) is not None and r["control"][k] > lim[k]
               for k in ("max_gap", "gapped_share"))


def _broken_run(monkeypatch, workload, fault):
    from otto_tpu_torch.engine import rank
    from otto_tpu_torch.pipeline import runner

    if fault == "altered":
        orig = rank.score_topk_multi

        def altered(b, rankers, top_k=20):
            out = orig(b, rankers, top_k)
            out[:, :, [0, 1]] = out[:, :, [1, 0]]   # the first two of every list swapped
            return out
        monkeypatch.setattr(rank, "score_topk_multi", altered)
    else:
        orig = runner.pipelined_consume

        def half(batch_iter, consume, pack=None, overlap=True):
            def drop(b, meta):
                n = len(b.session)
                b.session = b.session.copy()
                b.session[n // 2:] = -1          # half the sessions never reach the lists
                consume(b, meta)
            return orig(batch_iter, drop, pack, overlap)
        monkeypatch.setattr(runner, "pipelined_consume", half)
    spec, cfg, traffic = tiny(workload, n_trees=40)
    return harness.run_cell(workload, 5, 0.2, False, time.perf_counter(), device="cpu",
                            spec=spec, cfg=cfg, traffic=traffic, log=lambda *a: None)


@pytest.mark.parametrize("fault", ["altered", "half_batch"])
@pytest.mark.parametrize("workload", ["gbdt-passb", "gbdt-nearline"])
def test_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    out = _broken_run(monkeypatch, workload, fault)
    assert out["correct"] is False
    c = out["checks"]
    over = {k for k, v in c.items() if v["limit"] is not None and v["value"] > v["limit"]}
    if fault == "altered":
        assert over & {"max_gap", "gapped_share", "bad_lists"}
    else:
        assert "missing_sessions" in over


def test_gaps_of_a_list():
    from benchmark.reference.check import RefSession, list_gaps

    ref = {7: RefSession(np.array([5, 9, 2], np.int32),
                         {"full": np.array([[0.1, 0.9, 0.5]], np.float32)})}
    assert list_gaps({7: np.array([[9, 2, 5]])}, ref, 3) == (0.0, 0.0, 0, 1)
    g = list_gaps({7: np.array([[2, 9, 5]])}, ref, 3)
    assert g.bad_lists == 0 and abs(g.max_gap - 0.4) < 1e-6
    assert abs(g.gapped_share - 100 / 3) < 1e-9
    assert list_gaps({7: np.array([[9, 2, -1]])}, ref, 3).bad_lists == 1   # short
    assert list_gaps({7: np.array([[9, 2, 4]])}, ref, 3).bad_lists == 1    # not retrieved
    assert list_gaps({7: np.array([[9, 9, 5]])}, ref, 3).bad_lists == 1    # repeated
