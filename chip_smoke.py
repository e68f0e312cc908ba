#!/usr/bin/env python3
"""Smoke test of otto_tpu_torch, the PyTorch / CUDA port, on one GPU.

    python3 chip_smoke.py

Needs one CUDA device; with none it exits non-zero before doing anything.
Phases, each printed before the last line:

1. Device: the card's name and power limit, as nvidia-smi reports them.
2. Build: compile the port's CUDA kernels (otto_tpu_torch/csrc/*.cu) with
   nvcc for sm_90a; print the build seconds.
3. Kernel check: K1 (row gather) and K2 (segmented scan) against their
   plain PyTorch twins on the card at the main path's shapes, with CUDA
   event times of kernel and twin.
4. Main path at production width: synthetic OTTO-shaped sessions (1.8M
   aids, sessions up to 512 events, ~10k test sessions after the split,
   all four length buckets), a seeded retrieval context at production
   shape (co-visitation top-10/10/20/20/20, kNN k = 20, 50 clusters x 128
   popularity candidates, 100-d item embeddings: ~4.2 GB on the card) and
   three seeded GBDT rankers (150 trees, depth 4, 64 bins). Runs the
   port's score_pass (retrieval -> scoring -> top-20, batch 2048, 32 kept
   aids, 512 candidates) and submit_and_eval, and checks that K1 and K2
   were launched on the way. The seeded tables and trees stand in for the
   offline stages (co-visitation counting, word2vec + kNN, k-means +
   popularity, GBDT training) until those are ported; the recall they give
   says nothing about model quality. Each aid's seeded co-visitation and
   kNN neighbours lie within 64 ids of it, so the sources overlap and the
   groupbys merge duplicates; no deployment was measured for that, and
   real tables differ in overlap, row fill and count skew. The sessions/s
   this phase prints is a smoke reading of this one run, not a benchmark.
5. Cross-check: one 256-session batch on a 2^16-aid seeded context, run on
   the card (kernels) and on the CPU (twins): candidates and integer
   features bit-equal, float features within a stated tolerance.

Then one JSON line with the kernels' results and, last, the result line
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
then non-zero and the result line is not printed.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 1234
N_AIDS = 1_800_000
BATCH = 2048


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps=10):
    """Mean milliseconds per call of fn on the card (CUDA events, after one
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
# phases 1-3: device, build, kernels
# --------------------------------------------------------------------------
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    return smi


def phase_build():
    from otto_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"# build: {time.perf_counter() - t0:.2f} s -> "
          f"{_build.library_path().relative_to(_build.PKG_DIR.parent)}")
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        usage = [ln.strip() for ln in log.read_text().splitlines()
                 if "registers" in ln or "Compiling entry" in ln]
        for ln in usage:
            print(f"#   {ln}")


def phase_kernels(dev, smi):
    """Each kernel against its twin at main-path shapes. Returns
    {kernel: {max_abs_err, ms, plain_ms}} at the first (headline) shape."""
    from otto_tpu_torch.ops.kernels import gather, segscan

    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}

    def report(name, shape, err, ms, plain_ms):
        print(f"# {name} {shape}: max_abs_err {err:.3g}, kernel {ms:.3f} ms, "
              f"twin {plain_ms:.3f} ms ({smi})")
        if name.split()[0] not in out:
            out[name.split()[0]] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        else:
            o = out[name.split()[0]]
            o["max_abs_err"] = max(o["max_abs_err"], err)

    # K1: transport-sort shape (stacked columns moved through a row
    # permutation, W = P) and the GBDT tree-walk shape (W = T = 150 > P = F)
    for B, S, P, W, perm in ((40, 2048, 4096, 4096, True),
                             (1, 2048 * 512, 104, 150, False)):
        if perm:
            idx = torch.argsort(torch.rand((S, P), generator=g, device=dev),
                                dim=1).to(torch.int32)
        else:
            idx = torch.randint(0, P, (S, W), generator=g, device=dev,
                                dtype=torch.int32)
        for dtype in (torch.int32, torch.float32):
            if dtype == torch.int32:
                v = torch.randint(-2**31, 2**31 - 1, (B, S, P), generator=g,
                                  device=dev, dtype=torch.int32)
            else:
                v = torch.randn((B, S, P), generator=g, device=dev)
            got = gather.gather_rows(v, idx, check=True)
            want = gather.gather_rows_ref(v, idx)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"K1 {dtype} {(B, S, P, W)} bit-equal")
            ms = cuda_ms(lambda: gather.gather_rows(v, idx))
            plain = cuda_ms(lambda: gather.gather_rows_ref(v, idx))
            report(f"gather_rows {dtype}", (B, S, P, W), 0.0, ms, plain)
            del v, got, want
        del idx

    # K2: groupby-scan shape; segment starts from sorted random keys
    B, S, P = 20, 2048, 4096
    keys = torch.sort(torch.randint(0, 1000, (S, P), generator=g, device=dev),
                      dim=1).values
    first = torch.ones_like(keys, dtype=torch.bool)
    first[:, 1:] = keys[:, 1:] != keys[:, :-1]
    tol = 1e-4
    for dtype in (torch.int32, torch.float32):
        if dtype == torch.int32:
            v = torch.randint(-1000, 1000, (B, S, P), generator=g, device=dev,
                              dtype=torch.int32)
        else:
            v = torch.randn((B, S, P), generator=g, device=dev)
        for red in ("sum", "min", "max"):
            got = segscan.segmented_scan(v, first, red)
            want = segscan.segmented_scan_ref(v, first, red)
            torch.cuda.synchronize()
            if dtype == torch.float32 and red == "sum":
                # float sums: the kernel's sequential chunk carry and the
                # twin's Hillis-Steele tree associate differently
                err = float((got - want).abs().max())
                require(torch.allclose(got, want, rtol=tol, atol=tol),
                        f"K2 f32 sum within {tol}")
            else:
                err = 0.0
                require(torch.equal(got, want), f"K2 {dtype} {red} bit-equal")
            ms = cuda_ms(lambda: segscan.segmented_scan(v, first, red))
            plain = cuda_ms(lambda: segscan.segmented_scan_ref(v, first, red), reps=3)
            report(f"segmented_scan {dtype} {red}", (B, S, P), err, ms, plain)
            del got, want
        del v
    return out


# --------------------------------------------------------------------------
# seeded tables and rankers (stand-ins for the offline stages)
# --------------------------------------------------------------------------
def seeded_context(n_aids, device, seed, emb_dim=100):
    """A RetrievalContext at production shape, made on `device` from a
    seed: per-aid neighbour lists near the aid (so sources overlap and the
    groupbys have real duplicates to merge), descending counts, partly
    empty rows."""
    from otto_tpu_torch.config import COVIS_FIRST_N
    from otto_tpu_torch.engine.covis import CoVisTables
    from otto_tpu_torch.engine.retrieval import RetrievalContext

    g = torch.Generator(device=device).manual_seed(seed)
    i32 = torch.int32
    aid = torch.arange(n_aids, device=device)[:, None]

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=device)

    def near(n):
        return ((aid + ri(-64, 65, (n_aids, n))) % n_aids).to(i32)

    covis = []
    for n in COVIS_FIRST_N.values():
        n_valid = ri(0, n + 1, (n_aids, 1))
        present = torch.arange(n, device=device)[None, :] < n_valid
        count = torch.sort(ri(1, 1000, (n_aids, n)), dim=1, descending=True).values
        count = torch.where(present, count, 0)
        covis.append(CoVisTables(
            neighbor=torch.where(present, near(n), -1),
            count=count.to(i32),
            count_pop=torch.where(present, ri(0, 10_000, (n_aids, n)), 0).to(i32),
            perc_pop=torch.where(present, ri(0, 10_000, (n_aids, n)), 0).to(i32),
            count_rel=(count * 100 // count[:, :1].clamp(min=1)).to(i32),
        ))
    k = 20

    def knn():
        dist = torch.sort(torch.rand((n_aids, k), generator=g, device=device), dim=1)
        return near(k), dist.values

    emb = torch.randn((n_aids, emb_dim), generator=g, device=device)
    emb[torch.rand(n_aids, generator=g, device=device) < 0.05] = 0.0
    return RetrievalContext(
        covis=tuple(covis),
        knn_all=knn(),
        knn_1_2=knn(),
        pop_cl50_cand=ri(0, min(n_aids, 10_000), (50, 128)).to(i32),
        pop_cl50_ranks=ri(1, 60, (50, 128, 6)).to(i32),
        pop_cl1_rank=ri(1, 999, (n_aids, 6)).to(i32),
        aid_emb=emb,
    )


def seeded_rankers(feats, seed):
    """Three rankers at the default GBDTConfig (150 trees, depth 4, 64
    bins), seeded trees over bin edges fitted to retrieved features."""
    from otto_tpu_torch.config import TYPES, GBDTConfig
    from otto_tpu_torch.engine.retrieval import FEATURE_NAMES
    from otto_tpu_torch.models.gbdt import GBDTRanker

    cfg = GBDTConfig()
    qs = torch.linspace(0, 1, cfg.n_bins + 1, device=feats.device)[1:-1]
    edges = torch.quantile(feats, qs, dim=0).t().contiguous().cpu().numpy()
    rng = np.random.default_rng(seed)
    shape = (cfg.n_trees, cfg.max_depth, 2 ** (cfg.max_depth - 1))
    return {
        t: GBDTRanker(
            cfg=cfg,
            edges=edges.astype(np.float32),
            gfeat=rng.integers(0, len(FEATURE_NAMES), shape).astype(np.int32),
            thr=rng.integers(1, cfg.n_bins + 1, shape).astype(np.int32),
            leaf=rng.normal(0, 0.1, (cfg.n_trees, 2 ** cfg.max_depth)).astype(np.float32),
            feature_names=FEATURE_NAMES,
        )
        for t in TYPES
    }


def session_lookup(test, seed, emb_dim=100):
    from otto_tpu_torch.engine.retrieval import SessionLookup

    ids = np.unique(test.session)
    rng = np.random.default_rng(seed)
    return SessionLookup.build(
        ids, rng.integers(0, 50, len(ids)).astype(np.int32),
        rng.normal(size=(len(ids), emb_dim)).astype(np.float32),
    )


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------
def phase_main_path(dev, smi, n_aids=N_AIDS, n_sessions=40_000, batch=BATCH):
    from otto_tpu_torch.config import RetrievalConfig
    from otto_tpu_torch.data.batching import pack_sessions
    from otto_tpu_torch.data.split import split_events
    from otto_tpu_torch.data.synthetic import SyntheticSpec, generate
    from otto_tpu_torch.engine.retrieval import FEATURE_INDEX, Retriever
    from otto_tpu_torch.ops.kernels import gather, segscan
    from otto_tpu_torch.pipeline.runner import score_pass, submit_and_eval

    t0 = time.perf_counter()
    spec = SyntheticSpec(n_sessions=n_sessions, n_aids=n_aids, max_len=512,
                         mean_len=18, seed=SEED)
    sp = split_events(generate(spec, dev), test_days=7, seed=0)
    cfg = RetrievalConfig()
    buckets = {p.max_len: p.n_sessions
               for p in pack_sessions(sp.test, cfg.session_len_buckets)}
    n_test = int(np.unique(sp.test.session).size)
    print(f"# data: {len(sp.train)} train events, {n_test} test sessions, "
          f"buckets {buckets}, {time.perf_counter() - t0:.1f} s")
    require(set(buckets) == set(cfg.session_len_buckets), "all four buckets run")

    t0 = time.perf_counter()
    ctx = seeded_context(n_aids, dev, SEED)
    torch.cuda.synchronize()
    table_bytes = sum(t.nbytes for t in ctx.tensors())
    print(f"# tables: {table_bytes / 1e9:.2f} GB on the card, "
          f"{time.perf_counter() - t0:.1f} s")
    retriever = Retriever(ctx=ctx, cfg=cfg, sessions=session_lookup(sp.test, SEED))

    # warm-up batch: fits the rankers' bin edges to real features and pays
    # the one-time CUDA costs outside the timed pass
    b = next(retriever.iter_run(sp.test, batch_sessions=batch))
    valid = b.feats[..., FEATURE_INDEX["src_any"]] > 0
    sample = b.feats[valid][:100_000]
    rankers = seeded_rankers(sample, SEED)
    del b, valid, sample

    gather.launches = segscan.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    preds = score_pass(retriever, sp.test, rankers, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"gather_rows": gather.launches, "segmented_scan": segscan.launches}
    peak = torch.cuda.max_memory_allocated()
    with tempfile.TemporaryDirectory() as work:
        recall = submit_and_eval(work, preds, sp.labels)
    print(f"# main path: {n_test} sessions in {dt:.2f} s = "
          f"{n_test / dt:.1f} sessions/s, peak {peak / 2**30:.2f} GiB allocated, "
          f"launches {launches} ({smi})")
    print(f"# recall@20 (seeded rankers): {json.dumps(recall)}")
    require(all(n > 0 for n in launches.values()),
            f"every kernel launched on the main path: {launches}")
    for t, (s, a) in preds.items():
        require(s.shape == (n_test,) and a.shape == (n_test, 20), f"{t} shapes")
        require(((a >= -1) & (a < n_aids)).all(), f"{t} aids in range")
        require((a[:, 0] >= 0).mean() > 0.99, f"{t} sessions get predictions")
    require(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in recall.values()),
            "recall values in [0, 1]")
    return launches


# --------------------------------------------------------------------------
# phase 5: card against CPU
# --------------------------------------------------------------------------
FLOAT_FEATURES = ("cos_sim_ses_aid", "eucl_dist_ses_aid", "dist_w2vec_all",
                  "dist_w2vec_1_2", "heur_score")
# the float features are sums and dot products that the card reduces in
# another order than the CPU (K2's chunked scan vs the Hillis-Steele twin,
# cuBLAS vs the CPU's einsum), all in full float32 (TF32 off)
FLOAT_TOL = 1e-4


def phase_cross_check(dev):
    from otto_tpu_torch.config import RetrievalConfig
    from otto_tpu_torch.data.batching import pack_sessions
    from otto_tpu_torch.data.synthetic import SyntheticSpec, generate
    from otto_tpu_torch.engine.retrieval import FEATURE_INDEX, retrieve_batch

    n_aids, S = 1 << 16, 256
    ev = generate(SyntheticSpec(n_sessions=2000, n_aids=n_aids, max_len=32,
                                mean_len=14, seed=SEED + 1), dev)
    p = pack_sessions(ev, (32,))[0]
    cfg = RetrievalConfig()
    ctx_cpu = seeded_context(n_aids, torch.device("cpu"), SEED + 1)
    ctx_dev = ctx_cpu.to(dev)
    lookup = session_lookup(ev, SEED + 1)
    cluster, semb = lookup.lookup(p.session[:S])
    trim = [cfg.trim_max_at_order_1, cfg.trim_min,
            (cfg.trim_max_at_order_1 - cfg.trim_min) / (cfg.trim_min_at_order - 1)]

    def run(ctx, device):
        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x[:S])).to(device)

        out = retrieve_batch(
            (put(p.aid), put(p.ts), put(p.type)), ctx, put(cluster), put(semb),
            torch.tensor(trim, dtype=torch.float32, device=device),
            cfg.max_session_aids, cfg.max_candidates,
        )
        return [o.cpu() for o in out]

    (c_cpu, f_cpu, t_cpu), (c_dev, f_dev, t_dev) = run(ctx_cpu, "cpu"), run(ctx_dev, dev)
    require(torch.equal(c_cpu, c_dev), "cross-check candidates bit-equal")
    require(torch.equal(t_cpu, t_dev), "cross-check ts_order bit-equal")
    n_cand = int((c_cpu >= 0).sum())
    require(n_cand > 10 * S, f"cross-check has candidates ({n_cand})")
    worst = 0.0
    for name, j in FEATURE_INDEX.items():
        a, b = f_cpu[..., j], f_dev[..., j]
        if name in FLOAT_FEATURES:
            require(torch.allclose(a, b, rtol=FLOAT_TOL, atol=FLOAT_TOL),
                    f"cross-check {name} within {FLOAT_TOL}")
            worst = max(worst, float((a - b).abs().max()))
        else:
            require(torch.equal(a, b), f"cross-check {name} bit-equal")
    print(f"# cross-check: {S} sessions, {n_cand} candidates bit-equal, "
          f"integer features bit-equal, float features max |diff| {worst:.3g} "
          f"(tolerance {FLOAT_TOL})")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from otto_tpu_torch.device import pin_fp32, resolve

    dev = resolve("cuda")
    pin_fp32()
    smi = phase_device()
    phase_build()
    kernels = phase_kernels(dev, smi)
    torch.cuda.empty_cache()
    launches = phase_main_path(dev, smi)
    torch.cuda.empty_cache()
    phase_cross_check(dev)

    sources = {
        "gather_rows": ("otto_tpu_torch/csrc/gather_rows.cu",
                        "otto_tpu/ops/pallas/gather.py:54"),
        "segmented_scan": ("otto_tpu_torch/csrc/segscan.cu",
                           "otto_tpu/ops/pallas/segscan.py:90"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **kernels[name]}
        for name, (src, rep) in sources.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
