#!/usr/bin/env python3
"""Time the port's k-means (ops/kmeans.py) on the card at the table
build's shape.

    python3 scripts/bench_kmeans.py [--root DIR] [--points N]

Imports otto_tpu_torch from `--root` (default: this checkout), so two
checkouts can be timed in turns on one card: unpack the other one with
`git archive` into a directory that .gitignore lists and run this script
on each, A B B A. The points are 50 seeded Gaussian blobs in 100
dimensions (N = 500,000 by default, about the sessions of chip_smoke.py's
phase 4; the build clusters the session embeddings into 50 clusters).
Prints one JSON line: CUDA event ms of one Lloyd iteration (`lloyd_step`,
from the same k-means++ start), and wall seconds and iterations of the
whole `kmeans_fit` at KMeansConfig()'s max_iter and tol, each for every
replica count of the cluster sums where the checkout has
`SUM_REPLICAS` (1 and its own), with the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch

REPS = 20   # Lloyd iterations an event time averages


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--points", type=int, default=500_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_kmeans: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from otto_tpu_torch.device import pin_fp32
    from otto_tpu_torch.ops import kmeans

    pin_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    centres = torch.randn((50, 100), generator=g, device=dev) * 2.0
    pick = torch.randint(0, 50, (args.points,), generator=g, device=dev)
    x = centres[pick] + torch.randn((args.points, 100), generator=g, device=dev)
    init = kmeans.init_centroids(x, 50, 1 << 16, torch.Generator(device=dev).manual_seed(42))
    own = getattr(kmeans, "SUM_REPLICAS", None)
    out = {"root": root, "card": smi, "points": args.points, "runs": []}
    for reps in ([1, own] if own else [None]):
        if reps is not None:
            kmeans.SUM_REPLICAS = reps
        kmeans.lloyd_step(x, init)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            kmeans.lloyd_step(x, init)
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / REPS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, _, n_iter = kmeans.kmeans_fit(x, 50)
        torch.cuda.synchronize()
        out["runs"].append({"sum_replicas": reps, "lloyd_step_ms": step_ms,
                            "fit_s": time.perf_counter() - t0, "fit_iter": n_iter})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
