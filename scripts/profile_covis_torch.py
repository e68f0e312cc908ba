#!/usr/bin/env python3
"""Where the time of the port's co-visitation and popularity stages goes,
on one GPU, at chip_smoke.py's phase-4 size.

    python3 scripts/profile_covis_torch.py [--sessions 500000]

Generates the same synthetic sessions as chip_smoke.py (1.8M aids,
sessions up to 512 events, seed 1234), splits them, and runs
CoVisCounter.update(train), update(test), retrieval_tables(1.8M) and
compute_popularity over 50 clusters (sessions assigned round-robin) and
over one, under torch.profiler. Prints each step's wall seconds (ended by
a device sync), the counter's host dedup + packing seconds, the device's
busy seconds (the sum of CUDA kernel time) and the ops that took the most
device time, beside the card's name and power limit.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_AIDS = 1_800_000


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=500_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_covis_torch: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from otto_tpu_torch.config import CoVisConfig, PopularityConfig
    from otto_tpu_torch.data.split import split_events
    from otto_tpu_torch.data.synthetic import SyntheticSpec, generate_device
    from otto_tpu_torch.engine.covis import CoVisCounter
    from otto_tpu_torch.engine.popularity import compute_popularity

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    sp = split_events(generate_device(SyntheticSpec(
        n_sessions=args.sessions, n_aids=N_AIDS, max_len=512, mean_len=18, seed=1234),
        dev), test_days=7, seed=0)
    full = sp.train.concat(sp.test)
    print(f"# {len(full)} events, {args.sessions} sessions ({smi})")

    # warm-up: CUDA context, sort and scan kernels, the host merge library
    warm = CoVisCounter(CoVisConfig(), dev)
    warm.update(sp.test.select(np.arange(min(len(sp.test), 100_000))))
    warm.retrieval_tables(N_AIDS)
    warm.close()
    torch.cuda.synchronize()

    steps = {}
    counter = CoVisCounter(CoVisConfig(), dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, fn in (
            ("covis update(train)", lambda: counter.update(sp.train)),
            ("covis update(test)", lambda: counter.update(sp.test)),
            ("covis retrieval_tables", lambda: counter.retrieval_tables(N_AIDS)),
            ("popularity cl50", lambda: compute_popularity(
                full, (full.session % 50).astype(np.int32), 50, N_AIDS,
                PopularityConfig(), dev)),
            ("popularity cl1", lambda: compute_popularity(
                full, np.zeros(len(full), np.int32), 1, N_AIDS, PopularityConfig(), dev)),
        ):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            steps[name] = time.perf_counter() - t0
    counter.close()
    for name, s in steps.items():
        print(f"#   {name}: {s:.3f} s")
    print(f"#   of which host dedup + packing: {counter.host_seconds:.3f} s")
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    total = sum(steps.values())
    print(f"# device busy {busy_us / 1e6:.3f} s of {total:.3f} s wall "
          f"({100 * busy_us / 1e6 / total:.1f}%), under the profiler ({smi})")
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    for e in top:
        if e.self_device_time_total:
            print(f"#   {e.key[:70]:70s} {e.self_device_time_total / 1e3:10.1f} ms"
                  f"  x{e.count}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
