#!/usr/bin/env python3
"""Repeat chip_smoke.py's seeded-table retrieval cross-check on the card.

    python3 scripts/repeat_cross_check.py [--runs 50]

One process, one card: `--runs` times, a 256-session retrieval batch on
tables seeded with a new seed runs on the card and on the CPU
(chip_smoke.cross_check_retrieval: candidates and integer features
bit-equal, float features within chip_smoke.FLOAT_TOL). Prints each
failure's message (it names the entries it rejects), then one JSON line
with the run and failure counts and the card's name and power limit.
Needs a CUDA device.
"""
import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("repeat_cross_check: no CUDA device", file=sys.stderr)
        return 2
    from otto_tpu_torch.device import pin_fp32, resolve

    dev = resolve("cuda")
    pin_fp32()
    smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    failures = []
    t0 = time.perf_counter()
    for i in range(args.runs):
        seed = chip_smoke.SEED + 1 + i
        try:
            chip_smoke.cross_check_retrieval(dev, seed, quiet=True)
        except RuntimeError as e:
            failures.append({"seed": seed, "message": str(e)})
            print(f"# seed {seed}: {e}", flush=True)
    print(json.dumps({"runs": args.runs, "failures": len(failures),
                      "seeds_failed": [f["seed"] for f in failures],
                      "seconds": round(time.perf_counter() - t0, 1), "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
