#!/usr/bin/env python3
"""Time K1 (otto_tpu_torch's row gather, csrc/gather_rows.cu) on the card.

    python3 scripts/bench_k1.py [--root DIR]

Imports otto_tpu_torch from `--root` (default: this checkout), so two
checkouts of the port whose K1 takes a column list can be timed in turns
on one card: unpack the other one with `git archive` into a directory
that .gitignore lists and run this script on each, A B B A. At the
transport sort's shape (40 int32 columns at [2048, 4096] through row
permutations) and the GBDT tree walk's ([1, 1,048,576, 104] bins, 150
tree columns): the kernel on the stacked columns, bit-equal to torch.gather; CUDA event times of the
kernel, of one torch.gather and of a plain device copy of the source
(the card's practical copy rate), and the kernel's byte bound. Then the
host's cost of one call where the card's work is a few microseconds
(one of the serving sorts' shapes, 8 int32 columns at [2048, 8]): wall
microseconds a call over CALLS calls, K1 on the column list and on the
stack, and torch.gather on the stack. One JSON line with the card's name
and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12    # NVIDIA's H100 SXM data sheet, at 700 W
REPS = 20                    # calls a CUDA event time averages
CALLS = 2000                 # calls a host time averages


def cuda_ms(fn):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def host_us(fn):
    """Wall microseconds a call, the card's queue drained at both ends."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / CALLS * 1e6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_k1: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from otto_tpu_torch.ops.kernels import _build, gather

    _build.load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    rows = []
    for B, S, P, W, perm in ((40, 2048, 4096, 4096, True), (1, 2048 * 512, 104, 150, False)):
        if perm:
            idx = torch.argsort(torch.rand((S, P), generator=g, device=dev), dim=1).to(torch.int32)
        else:
            idx = torch.randint(0, P, (S, W), generator=g, device=dev, dtype=torch.int32)
        v = torch.randint(-2**31, 2**31 - 1, (B, S, P), generator=g, device=dev,
                          dtype=torch.int32)
        got = gather.gather_rows(v, idx)
        ix = idx.long().unsqueeze(0).expand(B, -1, -1)
        ok = torch.equal(got, torch.gather(v, 2, ix))
        ms = cuda_ms(lambda: gather.gather_rows(v, idx))
        lib = cuda_ms(lambda: torch.gather(v, 2, ix))
        # the card's practical rate for a plain device-to-device copy of the
        # source (read once, written once), beside the published 3.35 TB/s
        dst = torch.empty_like(v)
        copy = cuda_ms(lambda: dst.copy_(v))
        bound = 4 * (B * S * P + S * W + B * S * W) / HBM_BYTES_PER_S * 1e3
        rows.append({"shape": [B, S, P, W], "bit_equal": ok, "ms": ms, "torch_gather_ms": lib,
                     "bound_ms": bound, "share": bound / ms, "copy_ms": copy,
                     "copy_tb_per_s": 8 * B * S * P / copy / 1e9})
        del dst
        del v, got, ix, idx
    B, S, P = 8, 2048, 8
    idx = torch.argsort(torch.rand((S, P), generator=g, device=dev), dim=1).to(torch.int32)
    cols = [torch.randint(0, 1000, (S, P), generator=g, device=dev, dtype=torch.int32)
            for _ in range(B)]
    v = torch.stack(cols)
    ix = idx.long().unsqueeze(0).expand(B, -1, -1)
    host = {"shape": [B, S, P, P], "calls": CALLS,
            "k1_list_us": host_us(lambda: gather.gather_rows(cols, idx)),
            "k1_stacked_us": host_us(lambda: gather.gather_rows(v, idx)),
            "torch_gather_us": host_us(lambda: torch.gather(v, 2, ix))}
    print(json.dumps({"root": args.root, "k1": rows, "host": host, "card": smi}))
    return 0 if all(r["bit_equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
