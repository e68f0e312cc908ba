"""The MLA + MoE cell (benchmark/serve_mla_moe.py) at a tiny size on the CPU: a
run through the harness, traced and not, `correct`'s comparison (the
program within the limits, the control and altered lists past them), and
the routing flip share. The cell's widths (16B parameters) do not fit a CPU
test, so the model keys shrink too (d 64, 2 heads, 8 experts top 2, 1
shared, 1 dense and 2 MoE layers); every other setting is the cell's."""
from __future__ import annotations

import json
import time

import pytest

from benchmark import control_mla_moe, harness, serve_mla_moe
from benchmark.tests.bench_tiny import tiny

CELL = "moonlight-passb"
TINY_MODEL = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=2, kv_lora_rank=32,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                  intermediate_size=96, moe_intermediate_size=32, n_routed_experts=8,
                  num_experts_per_tok=2, n_shared_experts=1)


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    """Chunks of 500 tokens, so that a tiny batch spans several."""
    from otto_tpu_torch.models import mla_moe
    monkeypatch.setattr(mla_moe, "CHUNK_TOKENS", 500)


def tiny_cell():
    spec, cfg, traffic = tiny(CELL)
    cfg.update(TINY_MODEL)
    return spec, cfg, traffic


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run(trace):
    spec, cfg, traffic = tiny_cell()
    out = harness.run_cell(CELL, 2**31 + 9, 1.0, bool(trace), time.perf_counter(),
                           device="cpu", spec=spec, cfg=cfg, traffic=traffic,
                           log=lambda *a: None)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["lists_compared"]["value"] > 0
    # the program's expert sets are nearly the reference's top-k on the CPU
    # (a BLAS may sum a row of the packed batch in another order than the
    # session alone), and within the limits
    for key in ("routing_flip_share", "route_margin"):
        c = out["checks"][key]
        assert c["limit"] is not None and 0.0 <= c["value"] <= c["limit"]
    if trace:
        # a CPU run has no device trace: the device readers, and the span
        # readers that wait for one, find nothing
        assert set(out["metrics"]) <= {"runner.wait_share.serve"}
    else:
        assert set(out["metrics"]) == {"sessions_per_s", "setup_s"}
    json.dumps(out)


def test_control_and_routed_faults_fail_where_the_program_passes():
    """The control (float8 operands) and every planted routed fault come
    out not correct by the cell's limits; the program passes them."""
    spec, cfg, traffic = tiny_cell()
    r = control_mla_moe.readings(CELL, 3, 1, "cpu", cfg, traffic,
                                 faults=control_mla_moe.FAULTS)
    assert r["program"]["bad_lists"] == 0 and r["program"]["lists"] > 0
    assert r["program"]["correct"] is True
    assert r["control"]["correct"] is False
    lim = cfg["correct"]
    assert any(r["control"][k] > lim[k] for k in ("max_gap", "gapped_share"))
    assert set(r["faults"]) == set(control_mla_moe.FAULTS)
    for fault, got in r["faults"].items():
        assert got["correct"] is False, fault


def test_served_sets_are_the_sample_tokens_sets():
    """The sets recorded as the program served, put in the sample's token
    order, are the program's own sets for those tokens (a batch of other
    shapes may flip a near-tie: nearly all agree)."""
    import numpy as np
    import torch

    from benchmark import serve
    from otto_tpu_torch.pipeline import runner

    spec, cfg, traffic = tiny_cell()
    inp = serve_mla_moe.MLAMoEInputs(cfg, 11, torch.device("cpu"))
    retriever, rankers = serve_mla_moe._port(cfg, inp)
    rec = serve_mla_moe.ServedRouting(cfg)
    rec.install()
    try:
        ids = inp.request(0, traffic["sessions_per_request"])
        preds = runner.score_pass(retriever, serve._events(inp.columns(ids)), rankers,
                                  cfg["batch_sessions"])
    finally:
        rec.uninstall()
    served = serve._sample([(ids, preds)], inp, traffic, 11, cfg["top_k"])
    sample = serve_mla_moe.check_sample(cfg, inp, served)
    got = rec.sets_for(sample)
    want, lists = serve_mla_moe.encode_sample(cfg, sample, rankers["clicks"])
    assert len(got) == len(want) == cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    same = np.mean([float((a.sort(1).values == b.sort(1).values).all(1).float().mean())
                    for a, b in zip(got, want)])
    assert same > 0.99
    assert all(np.array_equal(lists[s], served[s]) for s in served) or same < 1.0


def test_altered_lists_are_not_correct(monkeypatch):
    from otto_tpu_torch.engine import rank

    orig = rank.score_topk_multi

    def altered(b, rankers, top_k=20):
        out = orig(b, rankers, top_k)
        out[:, :, [0, 1]] = out[:, :, [1, 0]]   # the first two of every list swapped
        return out
    monkeypatch.setattr(rank, "score_topk_multi", altered)
    spec, cfg, traffic = tiny_cell()
    out = harness.run_cell(CELL, 5, 0.2, False, time.perf_counter(), device="cpu",
                           spec=spec, cfg=cfg, traffic=traffic, log=lambda *a: None)
    assert out["correct"] is False
    c = out["checks"]
    assert {k for k, v in c.items() if v["limit"] is not None
            and v["value"] > v["limit"]} & {"max_gap", "gapped_share"}


def test_route_checks_judge_margin_and_flips():
    import torch

    from benchmark.reference.mla_moe import Routing

    r = Routing()
    r.margins = [torch.tensor([0.0, 0.0, 0.2]), torch.tensor([0.0, 0.01, 0.0])]
    checks, ok = serve_mla_moe.route_checks({"route_margin": 0.3, "routing_flip_share": 40.0}, r)
    assert ok and checks["routing_flip_share"]["value"] == pytest.approx(100.0 / 3)
    assert checks["route_margin"]["value"] == pytest.approx(0.2)
    assert not serve_mla_moe.route_checks({"route_margin": 0.1}, r)[1]
    assert not serve_mla_moe.route_checks({"routing_flip_share": 30.0}, r)[1]
    assert serve_mla_moe.route_checks({}, r)[1]           # no limits: printed only
    empty = serve_mla_moe.route_checks({"route_margin": 0.1}, Routing())
    assert empty[0]["route_margin"]["value"] is None and not empty[1]
