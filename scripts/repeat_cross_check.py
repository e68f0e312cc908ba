#!/usr/bin/env python3
"""Repeat chip_smoke.py's seeded-table retrieval cross-check on the card.

    python3 scripts/repeat_cross_check.py [--runs 50] [--history]

One process, one card: `--runs` times, a 256-session retrieval batch on
tables seeded with a new seed runs on the CPU, on the card and on the CPU
again (chip_smoke.cross_check_retrieval: candidates and integer features
bit-equal, float features within chip_smoke.FLOAT_TOL). Counts as a
failure a check that fails and a first CPU run that differs from the
second (fault 1 of ROADMAP Queue 3); prints each one's evidence (the
entries, the precision flags, both devices' input checksums, the
failing row recomputed in float32 and float64), then one JSON line with
the run and failure counts and the card's name and power limit.

`--history` first gives the process chip_smoke.py's history before its
cross-checks: the kernel phase (phase 3), the table build at production
width (phase 4: 500k generated sessions, through a Pipeline on a
temporary work dir), pass A over every test session and three rankers
(`--trees` trees each) from its rows, and a score_pass over every test
session (phase 5's path). Needs a CUDA device.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def history(dev, smi, trees):
    """chip_smoke.py's phases 3 to 5, the rankers cut to `trees` trees."""
    from otto_tpu_torch.config import TYPES, GBDTConfig, RankerConfig
    from otto_tpu_torch.pipeline.runner import load_downsampled, pass_a, score_pass, \
        train_ranker_cached

    t0 = time.perf_counter()
    chip_smoke.phase_kernels(dev, smi)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        work = os.path.join(root, "work")
        sp, retriever, _ = chip_smoke.phase_table_build(dev, smi, work)
        pass_a(retriever, sp.test, sp.labels, RankerConfig(), work,
               batch_sessions=chip_smoke.BATCH)
        rankers = {t: train_ranker_cached(work, t, lambda t=t: load_downsampled(work, t),
                                          GBDTConfig(n_trees=trees), dev, use_cache=False)
                   for t in TYPES}
        preds = score_pass(retriever, sp.test, rankers, chip_smoke.BATCH)
        n = len(preds["clicks"][0])
    del retriever
    torch.cuda.empty_cache()
    print(f"# history: kernels, build, pass A, {trees}-tree rankers and a score_pass over "
          f"{n} sessions in {time.perf_counter() - t0:.1f} s", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=50)
    ap.add_argument("--history", action="store_true",
                    help="run chip_smoke.py's phases 3-5 first, in this process")
    ap.add_argument("--trees", type=int, default=25, help="trees a ranker in --history")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("repeat_cross_check: no CUDA device", file=sys.stderr)
        return 2
    from otto_tpu_torch.device import pin_fp32, resolve

    dev = resolve("cuda")
    pin_fp32()
    smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    if args.history:
        history(dev, smi, args.trees)
    failures = []
    t0 = time.perf_counter()
    for i in range(args.runs):
        seed = chip_smoke.SEED + 1 + i
        try:
            first_run = chip_smoke.cross_check_retrieval(dev, seed, quiet=True)[-1]
            if first_run is not None:
                failures.append({"seed": seed, "message": first_run})
        except RuntimeError as e:
            failures.append({"seed": seed, "message": str(e)})
            print(f"# seed {seed}: {e}", flush=True)
    print(json.dumps({"runs": args.runs, "history": args.history, "failures": len(failures),
                      "seeds_failed": [f["seed"] for f in failures],
                      "seconds": round(time.perf_counter() - t0, 1), "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
