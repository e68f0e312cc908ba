"""Readings for the limits of `correct` in the MLA + MoE cell (benchmark/control.py's
counterpart for benchmark/serve_mla_moe.py).

For each seed, in one process: the cell's set-up, one warm-up request and
`--requests` requests of the cell's traffic through the program, then the
sample of served sessions that a run draws, retrieved again, with the
expert sets the program chose as it served them, then the plain
reference (benchmark/reference/mla_moe.py) over that sample in three
streams: at the configuration's precision ("full", bfloat16 operands) on
the program's expert sets, which the cell compares the program with; at
the nearest precision below it ("low", float8 e4m3 operands: the
control) on its own sets; and at the configuration's precision on the
control's sets, which the control is compared with as the program is
with the first. Prints one JSON line a seed: the program's readings and
the control's (list gaps, route margin, flip share), each judged by the
cell's limits.

`--faults` plants routed faults in the program's router at the cell's
weights and reads each the same way: the routed experts dropped
(weights 0), the correction bias in the weights, the weights not
normalised, not scaled by routed_scaling_factor, and the experts chosen
without the bias (its own stream on those sets).

    python benchmark/control_mla_moe.py --seeds 1 2 3 --requests 1 [--faults]
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


FAULTS = ("routed_dropped", "bias_in_weights", "unnormalised", "unscaled", "bias_not_chosen")


def fault_route(kind: str):
    """A stand-in for models/mla_moe.py::route with one fault planted."""
    import torch

    def route(h, wr, bias, top_k, scaling):
        s = torch.sigmoid(torch.mm(h, wr))
        z = s + bias
        idx = torch.topk(s if kind == "bias_not_chosen" else z, top_k, dim=1).indices
        w = (z if kind == "bias_in_weights" else s).gather(1, idx)
        if kind != "unnormalised":
            w = w / (w.sum(1, keepdim=True) + 1e-20)
        if kind != "unscaled":
            w = w * scaling
        if kind == "routed_dropped":
            w = torch.zeros_like(w)
        return idx, w
    return route


def judged(cfg, lists, ref, stream, routing) -> dict:
    """Readings of `lists` against the reference's `stream`, and whether
    the cell's limits pass them."""
    from benchmark import serve, serve_mla_moe
    from benchmark.reference import check

    g = check.list_gaps(lists, ref, cfg["top_k"], stream)
    checks, ok = serve.judge(cfg["correct"], g, 0)
    r_checks, r_ok = serve_mla_moe.route_checks(cfg["correct"], routing[stream])
    out = dict(g._asdict(), **{k: v["value"] for k, v in r_checks.items()})
    out["correct"] = bool(ok and r_ok)
    return out


def readings(workload: str, seed: int, requests: int, device: str = "cuda",
             cfg=None, traffic=None, faults=()) -> dict:
    import torch

    from benchmark import harness, serve, serve_mla_moe
    from benchmark.reference import check
    from otto_tpu_torch.pipeline import runner

    _, cfg0, traffic0 = harness.find_cell(harness.load_spec(), workload)
    cfg = cfg or cfg0
    traffic = traffic or traffic0
    dev = torch.device(device)
    t0 = time.perf_counter()
    inp = serve_mla_moe.MLAMoEInputs(cfg, seed, dev)
    retriever, rankers = serve_mla_moe._port(cfg, inp)
    R, N = traffic["sessions_per_request"], inp.stream.n_sessions
    done = []
    recorder = serve_mla_moe.ServedRouting(cfg)
    for i in range(-1, requests):
        if i == 0:
            recorder.install()
        ids = inp.request((i * R) % N, R)
        preds = runner.score_pass(retriever, serve._events(inp.columns(ids)), rankers,
                                  cfg["batch_sessions"])
        if i >= 0:
            done.append((ids, preds))
    recorder.uninstall()
    k = cfg["top_k"]
    served = serve._sample(done, inp, traffic, seed, k)
    sample = serve_mla_moe.check_sample(cfg, inp, served)
    routes = recorder.sets_for(sample)
    planted = {f: serve_mla_moe.encode_sample(cfg, sample, rankers["clicks"], fault_route(f))
               for f in faults}
    del retriever, rankers, done, recorder
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    streams = [("full", "full", routes), ("low", "low", None), ("ctrl", "full", "low")]
    streams += [(f, "full", planted[f][0]) for f in faults if f == "bias_not_chosen"]
    ref, routing = serve_mla_moe.reference(cfg, inp, sample, streams)
    ctrl_lists = check.control_lists(ref, k)
    out = {"workload": workload, "seed": seed,
           "program": judged(cfg, served, ref, "full", routing),
           "control": judged(cfg, ctrl_lists, ref, "ctrl", routing),
           "faults": {f: judged(cfg, planted[f][1], ref, f if f == "bias_not_chosen" else "full",
                                routing) for f in faults}}
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="moonlight-passb")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=1)
    ap.add_argument("--faults", action="store_true", help="read the planted routed faults too")
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("control_mla_moe: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.requests,
                                  faults=FAULTS if args.faults else ())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
