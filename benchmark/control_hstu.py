"""Readings for the limits of `correct` in the HSTU cell (benchmark/control.py's
counterpart for benchmark/serve_hstu.py).

For each seed, in one process: the cell's set-up, one warm-up request and
`--requests` requests of the cell's traffic through the program, then the
plain reference (benchmark/reference/hstu.py) over the sample of served
sessions that a run draws, at the configuration's precision ("full",
bfloat16 operands) and at the nearest precision below it ("low", float8
e4m3 operands: the control). Prints one JSON line a seed: the program's
readings (its lists against the full reference) and the control's (the
top-k of the low-precision scores against the full reference).

    python benchmark/control_hstu.py --seeds 1 2 3 --requests 1
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, seed: int, requests: int, device: str = "cuda",
             cfg=None, traffic=None) -> dict:
    import torch

    from benchmark import harness, serve, serve_hstu
    from benchmark.reference import check
    from otto_tpu_torch.pipeline import runner

    _, cfg0, traffic0 = harness.find_cell(harness.load_spec(), workload)
    cfg = cfg or cfg0
    traffic = traffic or traffic0
    dev = torch.device(device)
    t0 = time.perf_counter()
    inp = serve_hstu.HSTUInputs(cfg, seed, dev)
    retriever, rankers = serve_hstu._port(cfg, inp)
    R, N = traffic["sessions_per_request"], inp.stream.n_sessions
    done = []
    for i in range(-1, requests):
        ids = inp.request((i * R) % N, R)
        preds = runner.score_pass(retriever, serve._events(inp.columns(ids)), rankers,
                                  cfg["batch_sessions"])
        if i >= 0:
            done.append((ids, preds))
    k = cfg["top_k"]
    served = serve._sample(done, inp, traffic, seed, k)
    del retriever, rankers, done
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = serve_hstu.reference(cfg, inp, sorted(served), ("full", "low"))
    prog = check.list_gaps(served, ref, k, "full")
    ctrl = check.list_gaps(check.control_lists(ref, k), ref, k, "full")
    return {"workload": workload, "seed": seed, "seconds": time.perf_counter() - t0,
            "program": prog._asdict(), "control": ctrl._asdict()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="hstu-passb")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=1)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("control_hstu: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.requests)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
