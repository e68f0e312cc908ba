#!/usr/bin/env python3
"""Where GBDT LambdaRank training spends its time on the card.

    python3 scripts/probe_gbdt_train.py [--groups 97000] [--device cuda]

Seeded ranking rows at the rankers' width (104 features, 20-100 rows per
session group, f16 as pass A persists them), split 75/25 by session as
pipeline.runner.train_ranker_cached does, trained at GBDTConfig()
defaults on the card; then, at that training's shape, the time of one
tree's lambda gradients and of one level's histograms. A small case is
trained twice first (the two must give identical trees). Prints the
card's name and power limit beside the numbers. `--device cpu` runs the
same steps on the CPU (a rehearsal at a small --groups: its times are the
CPU's, not the card's).
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from otto_tpu_torch.config import GBDTConfig  # noqa: E402
from otto_tpu_torch.device import pin_fp32, resolve  # noqa: E402
from otto_tpu_torch.models import gbdt  # noqa: E402
from otto_tpu_torch.ops.kernels import _build, gather  # noqa: E402


def rows(n_groups, seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(20, 101, n_groups)
    sess = np.repeat(np.arange(n_groups), sizes)
    x = rng.normal(size=(len(sess), 104)).astype(np.float16)
    x[:, 50:60] = rng.integers(0, 5, (len(sess), 10))
    logit = x[:, 0].astype(np.float32) + (x[:, 1] > 0.5) + 0.5 * x[:, 50]
    y = (logit + rng.normal(size=len(sess)) > 3.0).astype(np.int8)
    return x, y, sess


def cuda_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=97_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve(args.device)
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        _build.load()
    else:
        smi = "CPU"
        torch.cuda.synchronize = torch.cuda.reset_peak_memory_stats = lambda *a: None
        torch.cuda.max_memory_allocated = lambda *a: 0
    pin_fp32()
    names = tuple(f"f{i}" for i in range(104))
    for n_groups in (2000, args.groups):
        x, y, sess = rows(n_groups, 0)
        u = np.unique(sess)
        vm = np.isin(sess, u[int(len(u) * 0.75):])
        cfg = GBDTConfig() if n_groups > 2000 else GBDTConfig(n_trees=10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gather.LAUNCHES.reset()
        t = time.perf_counter()
        m = gbdt.train_gbdt_ranker(x[~vm], y[~vm], sess[~vm], names, cfg,
                                   valid=(x[vm], y[vm], sess[vm]), device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        print(f"# {n_groups} groups, {len(y)} rows: {cfg.n_trees} trees in {dt:.2f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, K1 {gather.LAUNCHES.value}, "
              f"valid ndcg {[(n, round(v, 5)) for n, v in m.eval_history]} ({smi})",
              flush=True)
        if n_groups == 2000:
            m2 = gbdt.train_gbdt_ranker(x[~vm], y[~vm], sess[~vm], names, cfg,
                                        valid=(x[vm], y[vm], sess[vm]), device=dev)
            same = all(np.array_equal(getattr(m, k), getattr(m2, k))
                       for k in ("gfeat", "thr", "leaf", "gains"))
            print(f"#   trained twice: identical trees {same}", flush=True)

    # the parts of one tree at that shape
    t = time.perf_counter()
    edges = gbdt.compute_bin_edges(x[~vm], 64, seed=42)
    e_s = time.perf_counter() - t
    edges_d = torch.from_numpy(edges).to(dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    bins, lg, mg = gbdt._grouped_bins(x[~vm], y[~vm], sess[~vm], edges_d, GBDTConfig(), dev,
                                      group_mult=1024)
    torch.cuda.synchronize()
    b_s = time.perf_counter() - t
    print(f"# bin edges (host) {e_s:.2f} s, binning + grouping (card) {b_s:.2f} s ({smi})")
    NG, G = lg.shape
    sc = torch.randn(NG, G, device=dev)
    md = gbdt._max_dcg(lg, mg, 20)
    lead = ((lg > 0) & mg).any(0).nonzero()
    n_lead = int(lead.max()) + 1

    def grads():
        for c0 in range(0, NG, gbdt.CUDA_LAMBDA_GROUPS):
            sl = slice(c0, c0 + gbdt.CUDA_LAMBDA_GROUPS)
            gbdt._lambda_grads_chunk(sc[sl], lg[sl], mg[sl], md[sl], 1.0, 20, True, n_lead)

    real = mg.reshape(-1).nonzero()[:, 0]
    sub = bins[real][:, :26]
    node = torch.randint(0, 8, (len(real),), device=dev)
    q, _ = gbdt._fixed_point(gbdt._bf16(torch.randn(len(real), 3, device=dev)))
    print(f"# at {NG} groups x {G} slots ({len(real)} real rows, leading slots {n_lead}): "
          f"lambda gradients {cuda_ms(grads):.2f} ms per tree, one level's histograms "
          f"{cuda_ms(lambda: gbdt._histograms_fixed(sub, node, q, 8, 64)):.2f} ms ({smi})")
    for reps in (1, 8, 32, 128):
        gbdt.HIST_REPLICAS = reps
        print(f"#   histogram cell replicas {reps}: "
              f"{cuda_ms(lambda: gbdt._histograms_fixed(sub, node, q, 8, 64)):.2f} ms")

    # otto_tpu's formulation for comparison: per row chunk, a one-hot of
    # (feature, bin) times the node-weighted terms, float32 sums (TF32 on:
    # exact on bfloat16 operands); not deterministic under split-K sums
    gh = gbdt._bf16(torch.randn(len(real), 3, device=dev))
    chunk = 1 << 16

    def one_hot_product():
        acc = torch.zeros((26 * 64, 24), device=dev)
        for c0 in range(0, len(real), chunk):
            b = sub[c0: c0 + chunk].long() + torch.arange(26, device=dev) * 64
            oh = torch.zeros((len(b), 26 * 64), device=dev).scatter_(1, b, 1.0)
            ghc = (torch.nn.functional.one_hot(node[c0: c0 + chunk], 8)[:, :, None]
                   * gh[c0: c0 + chunk, None, :]).reshape(len(b), 24)
            acc += oh.t() @ ghc
        return acc

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ms = cuda_ms(one_hot_product)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"#   one-hot product, {chunk}-row chunks: {ms:.2f} ms per level ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
