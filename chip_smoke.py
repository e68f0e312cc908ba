#!/usr/bin/env python3
"""Smoke test of otto_tpu_torch, the PyTorch / CUDA port, on one GPU.

    python3 chip_smoke.py

Needs one CUDA device; with none it exits non-zero before doing anything.
Phases, each printed before the last line:

1. Device: the card's name and power limit, as nvidia-smi reports them.
2. Build: compile the port's CUDA kernels (otto_tpu_torch/csrc/*.cu, one
   nvcc per source, all at once) for sm_90a; print the build seconds.
3. Kernel check: K1 (row gather), K2 (segmented scan), K3 (top-k search)
   and K4 (table row gather) against their plain PyTorch twins on the card
   at the main paths' shapes (K1 at the transport sort's and at the GBDT
   tree walk's), with CUDA event times of kernel, twin and library call
   and each kernel's bound.
4. Table build at production width from the generated events: synthetic
   OTTO-shaped sessions (1.8M aids, sessions up to 512 events, 500k
   sessions, ~11.5M events) and the port's build_retriever at otto_tpu's
   default settings: co-visitation counting of train then test into five
   top-N tables (C7); both word2vec models of W2VEC_MODELS trained by SGNS
   on the card from those events (w2v-all on every event, w2v-1-2 on carts
   and orders; 100-d, window 10, 8 negatives, 5 epochs; C8), each with its
   vocabulary, step kind, steps, seconds, steps/s, pairs/s, first and last
   epoch loss and peak memory; kNN tables of k = 20 for the min(600,000,
   V) most frequent words of each model against all of its words (K3);
   session embeddings of every session (K4), k-means with 50 clusters,
   cluster popularity over 50 clusters and over one. Prints the counter's
   work and each stage's seconds and peak memory; checks the five tables,
   the losses (finite, falling), every kNN query its own nearest
   neighbour, each model's overlap with the click-to-click neighbours (at
   least 10x chance), the popularity tables and that K3 and K4 were
   launched.
4b. Training from what phase 4 built: the port's pass_a over every test
   session (~121k) with the split's labels (the label join, the
   per-source eval, negative downsampling; prints sessions/s, rows kept
   and sessions with a positive per target, the ceiling recall and
   candidates per session), then three GBDT rankers at GBDTConfig()
   defaults (104 features, 150 trees, depth 4, 64 bins) from its rows,
   each with its seconds, trees/s, peak memory and valid ndcg@20 every 25
   trees, which must beat label-blind orders of the same valid groups.
   Prints the recall of the two w2v retrieval sources beside their
   figures on the seeded models of commit ba4da48. Checks that K1 and K2
   ran in pass A and K1 in training.
5. Serving at production width from the built tables and the trained
   rankers: the port's score_pass (retrieval -> scoring -> top-20, batch
   2048, 32 kept aids, 512 candidates) over every test session and
   submit_and_eval, checking that K1 and K2 were launched; then the
   heuristic baseline over the same sessions on the built co-visitation
   tables; recall@20 per type beside the ceiling and the baseline's. The
   data are synthetic, so the recalls show that the rankers rank, not what
   real data would score; the sessions/s are smoke readings of this one
   run, not a benchmark.
6. Cross-check, small cases run on the card (kernels) and on the CPU
   (twins): one 256-session retrieval batch on seeded tables (candidates
   and integer features bit-equal, float features within a stated
   tolerance) and pass A's programs on it (packed meta, label bits,
   per-source counters, downsampled float16 rows: bit-equal); K3 through
   knn_search; session embeddings (within one float16 ulp); k-means from
   the same start; co-visitation tables in spill mode with the spill-time
   prune and with spill off, both popularity tables, and the baseline's
   top-20 (all bit-equal); GBDT histograms (bit-equal), a few trees from
   one set of draws on both devices (equal splits but at near ties,
   leaves within a stated tolerance) and two card trainings
   (bit-identical); SGNS: one block step and one pair step at production
   width from the same draws (tables and accumulators within a stated
   tolerance) and two card trainings of a small corpus in each step kind
   (bit-identical).

Then one JSON line with the kernels' results and, last, the result line
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
then non-zero and the result line is not printed.
"""
import contextlib
import dataclasses
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
N_SESSIONS = 500_000
EMB_D = 100
KNN_K = 20
KNN_QUERIES = 600_000      # knn_first_n_aids
N_CLUSTERS = 50

# K3 scores: 3xTF32 tensor-core sums in the kernel (about 2^-21 relative per
# product) against cuBLAS's float32 sums in the twin, far inside this share
# of the terms |q|^2 + |c|^2 they cancel; an index may differ from the
# twin's only where the kernel's pick, rescored in float64, lies within this
# tolerance of the twin's entry (a near-tie)
MIPS_TOL = 1e-4

# the card's published peaks (NVIDIA's H100 SXM data sheet, at 700 W): the
# kernels' bounds are bytes over HBM3's rate or operations over the peak
# of the units that run them
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12


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


def timed_once(fn):
    """(fn(), milliseconds of that one call on the card)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


# pass A's recall (total, all candidates) of the two w2v sources, and of
# them without the session's own aids, on the seeded word2vec models that
# stood in for SGNS training before it was ported:
# chip_smoke.py at its commit ba4da48 with INFO logging on, on an NVIDIA
# H100 80GB HBM3 at 700 W (same events and split as phase 4 here)
SEEDED_W2V_RECALL = {"src_w2vec_all": (0.4054, 0.0164), "src_w2vec_1_2": (0.4222, 0.0231)}

# K1 at the GBDT tree walk's shape (phase 3), and the walk's K1 launches
# on the paths that run it (phases 4b and 5)
WALK = {}


def zero_launch_counts():
    from otto_tpu_torch.ops.kernels import dma_gather, gather, mips, segscan

    for m in (gather, segscan, mips, dma_gather):
        m.launches = 0


def launch_counts():
    from otto_tpu_torch.ops.kernels import dma_gather, gather, mips, segscan

    return {"gather_rows": gather.launches, "segmented_scan": segscan.launches,
            "mips_topk": mips.launches, "gather_rows_hbm": dma_gather.launches}


@contextlib.contextmanager
def walk_launches(path):
    """Count into WALK["launches"][path] the K1 launches made inside the
    GBDT tree walk (models/gbdt.py::_predict_binned_program) meanwhile."""
    from otto_tpu_torch.models import gbdt
    from otto_tpu_torch.ops.kernels import gather

    inner = gbdt._predict_binned_program
    counts = WALK.setdefault("launches", {})
    counts[path] = 0

    def counted(*args):
        before = gather.launches
        out = inner(*args)
        counts[path] += gather.launches - before
        return out

    gbdt._predict_binned_program = counted
    try:
        yield
    finally:
        gbdt._predict_binned_program = inner


def topk_max_err(got, want, q, c, metric):
    """Hold K3's (scores, index) to the twin's: scores within MIPS_TOL of
    (1 + the largest |score|), an index differing only at a near-tie.
    -> (max |score difference|, number of differing indices)."""
    gs, gi = got
    ws, wi = want
    tol = MIPS_TOL * (1.0 + float(ws.abs().max()))
    err = float((gs - ws).abs().max()) if gs.numel() else 0.0
    require(err <= tol, f"K3 {metric} scores within {tol:.3g}: {err:.3g}")
    diff = gi != wi
    n_diff = int(diff.sum())
    if n_diff:
        rows = diff.nonzero()[:, 0]
        qq, cc = q[rows].double(), c[gi[diff].long()].double()
        s = (qq * cc).sum(1)
        if metric == "l2":
            s = 2 * s - (qq * qq).sum(1) - (cc * cc).sum(1)
        worst = float((s - ws[diff].double()).abs().max())
        require(worst <= tol, f"K3 {metric}: {n_diff} differing indices, "
                f"rescored {worst:.3g} from the twin's (tolerance {tol:.3g})")
        require(n_diff <= max(2, diff.numel() // 1000), f"K3 {metric}: {n_diff} near-ties")
    return err, n_diff


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
                 if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
        for ln in usage:
            print(f"#   {ln}")


def bound(n_bytes, n_tf32_ops=0.0):
    """(bound_ms, bound_by): the least time of the work on this card, the
    larger of its bytes over HBM's rate and its TF32 tensor-core
    operations over their peak."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_tf32_ops / TF32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase_kernels(dev, smi):
    """Each kernel against its twin at main-path shapes. Returns
    {kernel: {max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms}}
    at the first (headline) shape; max_abs_err is the worst over shapes."""
    from otto_tpu_torch.ops.kernels import dma_gather, gather, mips, segscan

    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}

    def report(name, shape, err, ms, plain_ms, headline=None):
        """headline: (bound_ms, bound_by, library_ms) of this shape; the
        first shape's go into the kernels line."""
        extra = ""
        if headline is not None:
            b_ms, b_by, lib_ms = headline
            lib = "none" if lib_ms is None else f"{lib_ms:.3f} ms"
            extra = (f", bound {b_ms:.3f} ms by {b_by} ({100 * b_ms / ms:.0f}% of it), "
                     f"library call {lib}")
        print(f"# {name} {shape}: max_abs_err {err:.3g}, kernel {ms:.3f} ms, "
              f"twin {plain_ms:.3f} ms{extra} ({smi})")
        key = name.split()[0]
        if key not in out:
            b_ms, b_by, lib_ms = headline
            out[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        else:
            out[key]["max_abs_err"] = max(out[key]["max_abs_err"], err)

    # K1: transport-sort shape (stacked columns moved through a row
    # permutation, W = P) and the GBDT tree-walk shape (W = T = 150 > P = F,
    # one level of one ranker on a 2048-session batch), each with its bound
    # and one torch.gather
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
            head = None
            if dtype == torch.int32:
                # library: one torch.gather on the stack, index prepared
                ix = idx.long().unsqueeze(0).expand(B, -1, -1)
                lib = cuda_ms(lambda: torch.gather(v, 2, ix))
                head = (*bound(4 * (B * S * P + S * W + B * S * W)), lib)
                del ix
                if not perm:   # the walk's int32 bins
                    WALK.update(shape=(B, S, P, W), ms=ms, plain_ms=plain,
                                bound_ms=head[0], bound_by=head[1], library_ms=lib)
            report(f"gather_rows {dtype}", (B, S, P, W), 0.0, ms, plain, head)
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
            # no one PyTorch call scans segments
            head = (*bound(4 * 2 * B * S * P + S * P), None)
            report(f"segmented_scan {dtype} {red}", (B, S, P), err, ms, plain, head)
            del got, want
        del v
    del keys, first

    # K3: one knn_search query block against the full corpus (the table
    # build's shape), then smaller blocks whose query blocks cannot fill the
    # card (the kernel splits the corpus into S ranges and merges)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for Q, V, metric in ((16384, N_AIDS, "l2"), (2048, 200_000, "l2"),
                         (1000, 100_000, "dot"), (2048, 200_000, "dot")):
        q = torch.randn((Q, EMB_D), generator=g, device=dev) * 0.3
        c = torch.randn((V, EMB_D), generator=g, device=dev) * 0.3
        got = mips.mips_topk(q, c, KNN_K, metric)
        want, plain = timed_once(lambda: mips.mips_topk_ref(q, c, KNN_K, metric))
        torch.cuda.synchronize()
        err, n_diff = topk_max_err(got, want, q, c, metric)
        ms = cuda_ms(lambda: mips.mips_topk(q, c, KNN_K, metric), reps=3)
        tflops = 2 * Q * V * EMB_D / (ms * 1e-3) / 1e12
        # 3xTF32: three TF32 products per float32 product on the tensor
        # cores; no one PyTorch call gives a top-k of a product
        head = (*bound(4 * (Q + V) * EMB_D + 8 * Q * KNN_K, 3 * 2 * Q * V * EMB_D), None)
        report(f"mips_topk {metric}", (Q, V, EMB_D, KNN_K), err, ms, plain, head)
        print(f"#   {tflops:.2f} TFLOP/s, split S = {mips.split_plan(Q, V, n_sm)[0]}, "
              f"{n_diff} near-tie index swaps, twin timed once")
        del q, c, got, want

    # K4: a session-embedding microbatch of 2^19 lanes from the item table,
    # and the int32 case
    n = 1 << 19
    ids = torch.randint(-2, N_AIDS + 2, (n,), generator=g, device=dev, dtype=torch.int32)
    for dtype in (torch.float32, torch.int32):
        if dtype == torch.float32:
            table = torch.randn((N_AIDS, EMB_D), generator=g, device=dev)
        else:
            table = torch.randint(-2**31, 2**31 - 1, (N_AIDS, EMB_D), generator=g,
                                  device=dev, dtype=torch.int32)
        got = dma_gather.gather_rows_hbm(table, ids)
        want = dma_gather.gather_rows_hbm_ref(table, ids)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"K4 {dtype} bit-equal")
        ms = cuda_ms(lambda: dma_gather.gather_rows_hbm(table, ids))
        plain = cuda_ms(lambda: dma_gather.gather_rows_hbm_ref(table, ids))
        # library: one index_select, the ids clipped beforehand (the
        # kernel clips them itself)
        ids64 = ids.clamp(0, N_AIDS - 1).long()
        lib = cuda_ms(lambda: torch.index_select(table, 0, ids64))
        head = (*bound(4 * n + 2 * 4 * n * EMB_D), lib)
        report(f"gather_rows_hbm {dtype}", (N_AIDS, EMB_D, n), 0.0, ms, plain, head)
        gbs = 2 * n * EMB_D * 4 / (ms * 1e-3) / 1e9
        print(f"#   {gbs:.1f} GB/s (row bytes read + written)")
        del table, got, want
    return out


# --------------------------------------------------------------------------
# the seeded tables of phase 6's retrieval cross-check
# --------------------------------------------------------------------------
def seeded_context(n_aids, device, seed, emb_dim=EMB_D):
    """A RetrievalContext of every table at its production width for
    `n_aids` aids, made on `device` from a seed: per-aid neighbour lists
    near the aid (so sources overlap and the groupbys have real duplicates
    to merge), descending counts, partly empty rows."""
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
    k = KNN_K

    def knn():
        dist = torch.sort(torch.rand((n_aids, k), generator=g, device=device), dim=1)
        return near(k), dist.values

    emb = torch.randn((n_aids, emb_dim), generator=g, device=device)
    emb[torch.rand(n_aids, generator=g, device=device) < 0.05] = 0.0
    return RetrievalContext(
        covis=tuple(covis),
        knn_all=knn(),
        knn_1_2=knn(),
        pop_cl50_cand=ri(0, min(n_aids, 10_000), (N_CLUSTERS, 128)).to(i32),
        pop_cl50_ranks=ri(1, 60, (N_CLUSTERS, 128, 6)).to(i32),
        pop_cl1_rank=ri(1, 999, (n_aids, 6)).to(i32),
        aid_emb=emb,
    )


def session_lookup(test, seed, emb_dim=EMB_D):
    from otto_tpu_torch.engine.retrieval import SessionLookup

    ids = np.unique(test.session)
    rng = np.random.default_rng(seed)
    return SessionLookup.build(
        ids, rng.integers(0, N_CLUSTERS, len(ids)).astype(np.int32),
        rng.normal(size=(len(ids), emb_dim)).astype(np.float32),
    )


# --------------------------------------------------------------------------
# phase 4: the table build
# --------------------------------------------------------------------------
def report_w2vec(rep, smi):
    """Print what each word2vec training ran, and hold its losses (finite,
    the last epoch's below the first's) and its kNN neighbours' overlap
    with the click-to-click co-visitation neighbours (at least 10x what
    k random words would share: k / V of a row's co-visitation
    neighbours, k^2 / V of k)."""
    for name, r in rep.w2vec.items():
        s = rep.seconds[f"w2vec {name}"]
        steps = r.steps_per_epoch * r.epochs
        loss = r.epoch_loss
        print(f"# w2vec {name}: V = {r.words} words, {r.positions} corpus positions, "
              f"{r.mode} steps of {r.pairs_per_step} pairs, {r.steps_per_epoch} steps x "
              f"{r.epochs} epochs in {s:.2f} s = {steps / s:.1f} steps/s, "
              f"{steps * r.pairs_per_step / s / 1e6:.2f}M pairs/s, peak "
              f"{rep.peak_bytes[f'w2vec {name}'] / 2**30:.2f} GiB; mean loss by epoch "
              f"{[round(x, 4) for x in loss]} ({smi})")
        require(all(np.isfinite(loss)) and loss[-1] < loss[0],
                f"{name}: losses finite and falling: {loss}")
        ov = rep.overlap[name]
        chance = KNN_K / r.words
        print(f"#   overlap with click-to-click neighbours: {ov['co_count_x_w2vec']:.4f} "
              f"of a row's (chance {chance:.2e}, i.e. {KNN_K * chance:.4f} of k = "
              f"{KNN_K}); w2vec backed by co-counts {ov['w2vec_x_co_count']:.4f}, "
              f"{ov['n_aids_compared']} aids compared, {ov['coverage_both']:.4f} of "
              f"the aids have both")
        require(ov["co_count_x_w2vec"] >= 10 * chance,
                f"{name}: overlap {ov['co_count_x_w2vec']} below 10x chance {chance}")


def phase_table_build(dev, smi):
    from otto_tpu_torch.config import COVIS_FIRST_N, W2VEC_MODELS, RetrievalConfig
    from otto_tpu_torch.data.batching import pack_sessions
    from otto_tpu_torch.data.split import split_events
    from otto_tpu_torch.data.synthetic import SyntheticSpec, generate
    from otto_tpu_torch.pipeline.runner import build_retriever

    t0 = time.perf_counter()
    spec = SyntheticSpec(n_sessions=N_SESSIONS, n_aids=N_AIDS, max_len=512,
                         mean_len=18, seed=SEED)
    sp = split_events(generate(spec, dev), test_days=7, seed=0)
    cfg = RetrievalConfig()
    buckets = {p.max_len: p.n_sessions
               for p in pack_sessions(sp.test, cfg.session_len_buckets)}
    n_test = int(np.unique(sp.test.session).size)
    print(f"# data: {len(sp.train)} train and {len(sp.test)} test events, "
          f"{n_test} test sessions, buckets {buckets}, "
          f"{time.perf_counter() - t0:.1f} s")
    require(set(buckets) == set(cfg.session_len_buckets), "all four buckets run")

    zero_launch_counts()
    t0 = time.perf_counter()
    retriever, rep = build_retriever(sp.train, sp.test, N_AIDS, dev, retrieval=cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak = max(rep.peak_bytes.values())
    print(f"# table build: {dt:.2f} s, peak {peak / 2**30:.2f} GiB allocated, "
          f"launches {launches} ({smi})")
    for stage, s in rep.seconds.items():
        extra = ""
        if stage.startswith("knn "):
            q = min(KNN_QUERIES, rep.w2vec[stage[4:]].words)
            v = rep.w2vec[stage[4:]].words
            extra = (f" ({q} queries x {v} x {EMB_D}: "
                     f"{2 * q * v * EMB_D / s / 1e12:.2f} TFLOP/s)")
        print(f"#   {stage}: {s:.3f} s, peak {rep.peak_bytes[stage] / 2**30:.2f} GiB{extra}")
    report_w2vec(rep, smi)
    cv = rep.covis
    print(f"# covis: {cv['host_seconds']:.3f} s of host dedup and packing, "
          f"{cv['microbatches']} microbatches, {cv['lanes']} grid lanes, "
          f"{cv['pairs']} pairs emitted, {cv['ladder_merges']} ladder merges, "
          f"{cv['rows_spilled']} rows spilled, {cv['rows_pruned']} pruned at spill, "
          f"host merge {cv['host_merge']}")
    for name, (before, after) in cv["unique_pairs"].items():
        print(f"#   {name}: {before} unique pairs, {after} after the global prune, "
              f"{cv['rows_with_neighbours'][name]} aids with a neighbour")
    print(f"# popularity: {json.dumps(rep.popularity)}")
    km = rep.kmeans
    print(f"# kmeans: inertia {km['inertia']:.1f}, {km['n_iter']} iterations, "
          f"{km['n_nonempty']} of {N_CLUSTERS} clusters non-empty, "
          f"{km['n_points']} sessions")
    require(launches["mips_topk"] > 0 and launches["gather_rows_hbm"] > 0,
            f"K3 and K4 launched by the table build: {launches}")

    ctx = retriever.ctx
    for (name, first_n), t in zip(COVIS_FIRST_N.items(), ctx.covis):
        for f in t:
            require(f.shape == (N_AIDS, first_n) and f.device.type == "cuda",
                    f"{name} table shape and device")
        present = t.count > 0
        require(int(present[:, 0].sum()) > 0, f"{name} has rows")
        require(bool((t.count[:, 1:] <= t.count[:, :-1]).all()),
                f"{name} counts non-increasing along a row")
        require(bool(((t.neighbor == -1) == ~present).all()),
                f"{name} neighbour -1 exactly where the count is 0")
        require(bool((t.count_rel[present[:, 0], 0] == 100).all()),
                f"{name} count_rel 100 in column 0")
    require(ctx.pop_cl50_cand.shape == (N_CLUSTERS, 128)
            and ctx.pop_cl50_ranks.shape == (N_CLUSTERS, 128, 6)
            and ctx.pop_cl1_rank.shape == (N_AIDS, 6), "popularity table shapes")
    for r in (ctx.pop_cl50_ranks, ctx.pop_cl1_rank):
        require(bool(((r >= 1) & (r <= 999)).all()), "popularity ranks in [1, 999]")
    require(rep.popularity["cl50"]["candidates_total"] > 0, "popularity candidates")

    for name, (nbr, dist) in zip(W2VEC_MODELS, (ctx.knn_all, ctx.knn_1_2)):
        V = rep.w2vec[name].words
        q = min(KNN_QUERIES, V)
        require(nbr.shape == (N_AIDS, KNN_K) and dist.shape == (N_AIDS, KNN_K),
                f"{name} kNN table shape")
        rows = (nbr[:, 0] >= 0).nonzero()[:, 0]
        require(len(rows) == q, f"{name}: {q} query rows, got {len(rows)}")
        self_hit = float((nbr[rows, 0] == rows).float().mean())
        print(f"# {name}: self is the nearest neighbour for {self_hit:.4f} of the "
              f"{q} queries")
        require(self_hit > 0.999, f"{name} self-neighbour share {self_hit}")
        d = dist[rows]
        require(bool(torch.isfinite(d).all()) and bool((d[:, 1:] >= d[:, :-1]).all()),
                f"{name} distances finite and ascending")
        require(bool((nbr[rows] >= 0).all()), f"{name}: k neighbours per query")
    lookup = retriever.sessions
    n_sessions = int(np.unique(np.concatenate([sp.train.session, sp.test.session])).size)
    require(len(lookup.ids) == n_sessions, "every session embedded")
    require(bool(np.isfinite(lookup.emb).all()), "session embeddings finite")
    require(lookup.cluster.min() >= 0 and lookup.cluster.max() < N_CLUSTERS,
            "cluster labels in range")
    require(km["n_nonempty"] > 1, "k-means found several clusters")
    return sp, retriever, launches


# --------------------------------------------------------------------------
# phase 4b: training from the built tables
# --------------------------------------------------------------------------
def valid_baselines(feats, y, sess, cfg):
    """Valid ndcg@k of two label-blind orders on the valid groups the
    trainer evaluates (train_ranker_cached's 75/25 session split, capped
    and grouped as train_gbdt_ranker does): all-zero scores, random
    scores, and the candidates' recency order (ts_order_aid, ties at
    random). All-zero scores rank each group in slot order, and the groups
    hold their positives first, so that ndcg is 1 by construction: it is
    printed, and the check compares with the other two."""
    from otto_tpu_torch.engine.retrieval import FEATURE_INDEX
    from otto_tpu_torch.models.gbdt import _cap_groups
    from otto_tpu_torch.models.ranker import _group_pad, ndcg_at_k

    u = np.unique(sess)
    vmask = np.isin(sess, u[max(1, int(len(u) * 0.75)):])
    vf, vy, vs = _cap_groups(feats[vmask], y[vmask], sess[vmask],
                             cfg.max_valid_groups, cfg.seed, "valid")
    fg, lg, mg = _group_pad(vf[:, [FEATURE_INDEX["ts_order_aid"]]], vy, vs, cfg.max_group)
    jitter = np.random.default_rng(SEED).random(lg.shape) * 1e-3
    return {"zero": ndcg_at_k(np.zeros(lg.shape), lg, mg, cfg.ndcg_at),
            "random": ndcg_at_k(jitter, lg, mg, cfg.ndcg_at),
            "recency": ndcg_at_k(-fg[..., 0].astype(np.float64) + jitter, lg, mg,
                                 cfg.ndcg_at),
            "groups": lg.shape[0]}


def phase_training(dev, smi, sp, retriever, work, batch=BATCH):
    """Pass A over every test session with the split's labels, then the
    three rankers at GBDTConfig() defaults from its rows. -> (rankers,
    pass A launches, training launches, pass A metrics)."""
    from otto_tpu_torch.config import TYPES, GBDTConfig, RankerConfig
    from otto_tpu_torch.pipeline.runner import (
        load_downsampled,
        pass_a,
        train_ranker_cached,
    )

    n_test = int(np.unique(sp.test.session).size)
    zero_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics, rep = pass_a(retriever, sp.test, sp.labels, RankerConfig(), work,
                          batch_sessions=batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    pa_launches = launch_counts()
    print(f"# pass A: {rep.sessions} sessions in {rep.batches} batches, {dt:.2f} s = "
          f"{rep.sessions / dt:.1f} sessions/s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated, "
          f"launches {pa_launches} ({smi})")
    print(f"#   seconds by phase: {json.dumps({k: round(v, 3) for k, v in rep.phases.items()})}")
    for t in TYPES:
        print(f"#   {t}: {rep.rows[t]} rows kept, {rep.positive_sessions[t]} sessions "
              f"with a positive")
    print(f"#   ceiling recall: {json.dumps({k: metrics[k] for k in metrics if k.startswith('ceiling')})}")
    print(f"#   candidates/session: mean {metrics['cand_per_session_mean']:.1f} "
          f"min {metrics['cand_per_session_min']} max {metrics['cand_per_session_max']}")
    require(rep.sessions == n_test, "pass A covers every test session")
    require(pa_launches["gather_rows"] > 0 and pa_launches["segmented_scan"] > 0,
            f"K1 and K2 launched in pass A: {pa_launches}")
    require(all(rep.rows[t] > 0 and rep.positive_sessions[t] > 0 for t in TYPES),
            "every target has rows")
    require(0.0 < metrics["ceiling_total"] < 1.0, "ceiling recall in (0, 1)")
    with open(os.path.join(work, "eval_retrieved_sources.json")) as fh:
        sources = json.load(fh)
    for src, seeded in SEEDED_W2V_RECALL.items():
        got = {f: sources[f]["total"]["topall"] for f in (src, f"{src} & not self")}
        print(f"#   {src} recall (total, all candidates; & not self): "
              f"{got[src]:.5f}, {got[src + ' & not self']:.5f}; on the seeded "
              f"models {seeded[0]:.4f}, {seeded[1]:.4f}")

    cfg = GBDTConfig()
    rankers = {}
    zero_launch_counts()
    with walk_launches("training"):
        for t in TYPES:
            feats, y, sess = load_downsampled(work, t)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r = train_ranker_cached(work, t, lambda: (feats, y, sess), cfg, dev,
                                    use_cache=False)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            base = valid_baselines(feats, y, sess, cfg)
            n_groups = int(np.unique(sess).size)
            print(f"# ranker {t}: {len(y)} rows, {n_groups} groups ({base['groups']} "
                  f"valid), {dt:.2f} s = {cfg.n_trees / dt:.2f} trees/s, peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated ({smi})")
            print(f"#   valid ndcg@{cfg.ndcg_at} by trees: "
                  f"{json.dumps([[n, round(v, 5)] for n, v in r.eval_history])}; "
                  f"all-zero {base['zero']:.5f}, random {base['random']:.5f}, "
                  f"recency order {base['recency']:.5f}")
            final = r.eval_history[-1][1]
            require(len(r.leaf) == cfg.n_trees and r.gfeat.shape[1:] == (4, 8),
                    f"{t}: {cfg.n_trees} trees of depth 4")
            require(final > max(base["random"], base["recency"]),
                    f"{t}: final valid ndcg {final:.5f} beats the label-blind orders")
            rankers[t] = r
    tr_launches = launch_counts()
    print(f"# training launches {tr_launches}, of them the tree walk's "
          f"{WALK['launches']['training']} ({smi})")
    require(tr_launches["gather_rows"] > 0, f"K1 launched in training: {tr_launches}")
    return rankers, pa_launches, tr_launches, metrics


# --------------------------------------------------------------------------
# phase 5: serving from the built tables and the trained rankers
# --------------------------------------------------------------------------
def phase_main_path(dev, smi, sp, retriever, rankers, ceiling, batch=BATCH):
    from otto_tpu_torch.pipeline.runner import score_pass, submit_and_eval

    n_test = int(np.unique(sp.test.session).size)
    table_bytes = sum(t.nbytes for t in retriever.ctx.tensors())
    print(f"# serving tables: {table_bytes / 1e9:.2f} GB on the card "
          f"(co-visitation, kNN and popularity tables, item embeddings and "
          f"session lookup, all from the build)")

    # warm-up batch: pays the one-time CUDA costs outside the timed pass
    b = next(retriever.iter_run(sp.test, batch_sessions=batch))
    rankers["clicks"].predict_scores_device(b.feats)
    del b

    zero_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with walk_launches("serving"):
        preds = score_pass(retriever, sp.test, rankers, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with tempfile.TemporaryDirectory() as work:
        recall = submit_and_eval(work, preds, sp.labels)
    print(f"# main path: {n_test} sessions in {dt:.2f} s = "
          f"{n_test / dt:.1f} sessions/s, peak {peak / 2**30:.2f} GiB allocated, "
          f"launches {launches}, of them the tree walk's "
          f"{WALK['launches']['serving']} ({smi})")
    require(launches["gather_rows"] > 0 and launches["segmented_scan"] > 0,
            f"K1 and K2 launched on the serving path: {launches}")
    for t, (s, a) in preds.items():
        require(s.shape == (n_test,) and a.shape == (n_test, 20), f"{t} shapes")
        require(((a >= -1) & (a < N_AIDS)).all(), f"{t} aids in range")
        require((a[:, 0] >= 0).mean() > 0.99, f"{t} sessions get predictions")
    require(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in recall.values()),
            "recall values in [0, 1]")
    base = phase_baseline(smi, sp, retriever, n_test)
    print("# recall@20, trained rankers / retrieval ceiling / baseline:")
    for k in ("clicks", "carts", "orders", "total"):
        print(f"#   {k}: {recall[k]:.5f} / {ceiling['ceiling_' + k]:.5f} / {base[k]:.5f}")
    require(all(recall[k] <= ceiling["ceiling_" + k] + 1e-12 for k in recall),
            "recall@20 within the retrieval ceiling")
    return launches


def phase_baseline(smi, sp, retriever, n_test):
    """The heuristic baseline over every test session on the built
    co-visitation tables. -> its recall@20."""
    from otto_tpu_torch.config import COVIS_FIRST_N, TYPES
    from otto_tpu_torch.engine import baseline
    from otto_tpu_torch.eval.recall import evaluate_topk

    tables = dict(zip(COVIS_FIRST_N, retriever.ctx.covis))
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sessions, aids = baseline.recommend(sp.test, tables)
    dt = time.perf_counter() - t0
    launches = launch_counts()
    recall = evaluate_topk({t: (sessions, aids) for t in TYPES}, sp.labels)
    print(f"# baseline: {n_test} sessions in {dt:.2f} s = {n_test / dt:.1f} "
          f"sessions/s, launches {launches}, recall@20 {json.dumps(recall)} ({smi})")
    require(sessions.shape == (n_test,) and aids.shape == (n_test, 20), "baseline shapes")
    require(((aids >= -1) & (aids < N_AIDS)).all(), "baseline aids in range")
    require(launches["gather_rows"] > 0 and launches["segmented_scan"] > 0,
            f"K1 and K2 launched by the baseline: {launches}")
    require(0.0 < recall["total"] <= 1.0, "baseline recall in (0, 1]")
    return recall


# --------------------------------------------------------------------------
# phase 6: card against CPU
# --------------------------------------------------------------------------
FLOAT_FEATURES = ("cos_sim_ses_aid", "eucl_dist_ses_aid", "dist_w2vec_all",
                  "dist_w2vec_1_2", "heur_score")
# the float features are sums and dot products that the card reduces in
# another order than the CPU (K2's chunked scan vs the Hillis-Steele twin,
# cuBLAS vs the CPU's einsum), all in full float32 (TF32 off)
FLOAT_TOL = 1e-4
# k-means: the per-cluster sums and distances are float32 matmuls summed in
# other orders on the two devices; the inertia is a float32 sum of ~8k terms
KMEANS_RTOL = 1e-4
# GBDT card vs CPU from the same draws: the exact histograms agree bit for
# bit, but the gradients' exp and log differ by an ulp between the two
# devices' libraries; a gradient an ulp apart may round to another
# bfloat16 (a 2^-8 step of one row's term), which moves a leaf in the
# fourth digit, and a split choice only where two gains lie that close
LEAF_TOL = 2e-4
GAIN_RTOL = 1e-4
# SGNS card vs CPU from the same draws: both sum a row's updates exactly
# (int64 fixed point), but the updates themselves come from cuBLAS vs the
# CPU's bmm and the devices' exp and rsqrt, which differ by ulps
SGNS_RTOL = 1e-5
SGNS_ATOL = 1e-6


def f16_ulp(x):
    """The spacing of float16 values at |x| (2^-24 below the normal range)."""
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0**-14)))
    return torch.exp2(e - 10)


def cross_check_retrieval(dev, seed, quiet=False):
    """One 256-session retrieval batch on tables seeded with `seed`, on the
    card and on the CPU: candidates, ts_order and integer features
    bit-equal, float features within FLOAT_TOL. -> (sessions, ctx_cpu,
    events, card outputs (cand, feats, ts_order) on the CPU)."""
    from otto_tpu_torch.config import RetrievalConfig
    from otto_tpu_torch.data.batching import pack_sessions
    from otto_tpu_torch.data.synthetic import SyntheticSpec, generate
    from otto_tpu_torch.engine.retrieval import FEATURE_INDEX, retrieve_batch

    cpu = torch.device("cpu")
    n_aids, S = 1 << 16, 256
    ev = generate(SyntheticSpec(n_sessions=2000, n_aids=n_aids, max_len=32,
                                mean_len=14, seed=seed), dev)
    p = pack_sessions(ev, (32,))[0]
    cfg = RetrievalConfig()
    ctx_cpu = seeded_context(n_aids, cpu, seed)
    ctx_dev = ctx_cpu.to(dev)
    lookup = session_lookup(ev, seed)
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

    def parts(s, c):
        """The session's and the candidate's norms and their dot product,
        recomputed on each device (CPU, card) for a failing entry."""
        out = []
        for ctx, device in ((ctx_cpu, "cpu"), (ctx_dev, dev)):
            e = torch.from_numpy(np.ascontiguousarray(semb[s])).to(device)
            a = ctx.aid_emb[int(c_cpu[s, c])]
            out.append(tuple(round(float(x), 6) for x in (
                torch.linalg.norm(e), torch.linalg.norm(a), (e * a).sum())))
        return out
    require(torch.equal(c_cpu, c_dev), "cross-check candidates bit-equal")
    require(torch.equal(t_cpu, t_dev), "cross-check ts_order bit-equal")
    n_cand = int((c_cpu >= 0).sum())
    require(n_cand > 10 * S, f"cross-check has candidates ({n_cand})")
    worst = 0.0
    for name, j in FEATURE_INDEX.items():
        a, b = f_cpu[..., j], f_dev[..., j]
        if name in FLOAT_FEATURES:
            bad = ~torch.isclose(a, b, rtol=FLOAT_TOL, atol=FLOAT_TOL)
            where = [(s, c, float(a[s, c]), float(b[s, c]), int(c_cpu[s, c]), parts(s, c))
                     for s, c in bad.nonzero()[:4].tolist()]
            require(not bad.any(), f"cross-check {name} within {FLOAT_TOL}: "
                    f"{int(bad.sum())} entries off, (session row, slot, CPU, card, "
                    f"candidate, (|session|, |candidate|, dot) on the CPU and the card "
                    f"recomputed) {where}")
            worst = max(worst, float((a - b).abs().max()))
        else:
            require(torch.equal(a, b), f"cross-check {name} bit-equal")
    if not quiet:
        print(f"# cross-check: {S} sessions, {n_cand} candidates bit-equal, "
              f"integer features bit-equal, float features max |diff| {worst:.3g} "
              f"(tolerance {FLOAT_TOL})")
    return p.session[:S], ctx_cpu, ev, (c_dev, f_dev, t_dev)


def phase_cross_check(dev):
    from otto_tpu_torch.data.batching import pack_sessions
    from otto_tpu_torch.engine.session_embed import compute_session_embeddings
    from otto_tpu_torch.ops import kmeans
    from otto_tpu_torch.ops.knn import knn_search

    cpu = torch.device("cpu")
    sessions, ctx_cpu, ev, (cand, feats, _) = cross_check_retrieval(dev, SEED + 1)
    ctx_dev = ctx_cpu.to(dev)
    cross_check_pass_a(dev, sessions, cand, feats)

    # K3 through knn_search, two query blocks
    emb = ctx_cpu.aid_emb[: 1 << 15]
    got = knn_search(emb[:600].to(dev), emb.to(dev), KNN_K, query_block=512)
    want = knn_search(emb[:600], emb, KNN_K, query_block=512)
    err, n_diff = topk_max_err([x.cpu() for x in got], want, emb[:600], emb, "l2")
    print(f"# cross-check knn_search: 600 x {emb.shape[0]} x {EMB_D}, scores "
          f"max |diff| {err:.3g}, {n_diff} near-tie index swaps")

    # session embeddings: K4 + einsum on the card, the twins on the CPU
    batches = pack_sessions(ev)
    ids_d, e_d = compute_session_embeddings(batches, ctx_dev.aid_emb)
    ids_c, e_c = compute_session_embeddings(batches, ctx_cpu.aid_emb)
    require(np.array_equal(ids_d, ids_c), "session ids equal")
    e_d = e_d.cpu()
    ulp = f16_ulp(torch.maximum(e_d.abs(), e_c.abs()))
    d = (e_d - e_c).abs()
    require(bool((d <= ulp).all()), "session embeddings within one float16 ulp")
    print(f"# cross-check session embeddings: {len(ids_c)} sessions, "
          f"{int((d > 0).sum())} of {d.numel()} values one float16 ulp apart")

    # k-means from one start: 50 blobs in 100-d
    g = torch.Generator().manual_seed(SEED)
    centres = torch.randn((N_CLUSTERS, EMB_D), generator=g) * 3
    x = centres[torch.randint(0, N_CLUSTERS, (8192,), generator=g)]
    x = x + torch.randn(x.shape, generator=g)
    init = kmeans.init_centroids(x, N_CLUSTERS, 1 << 16, g)
    cents, lab_c, in_c, it_c = kmeans.lloyd_fit(x, init)
    _, lab_d, in_d, it_d = kmeans.lloyd_fit(x.to(dev), init.to(dev))
    lab_d = lab_d.cpu()
    swapped = (lab_c != lab_d).nonzero()[:, 0]
    if len(swapped):
        # a point may change sides only where its two centroids tie
        dd = torch.cdist(x[swapped].double(), cents.double()) ** 2
        gap = (dd.gather(1, lab_c[swapped, None].long())
               - dd.gather(1, lab_d[swapped, None].long())).abs()
        require(bool((gap <= 1e-3 * dd.min(1, keepdim=True).values.clamp(min=1)).all()),
                "k-means labels differ only at near-ties")
    rel = abs(in_d - in_c) / max(abs(in_c), 1e-30)
    require(rel <= KMEANS_RTOL, f"k-means inertia within {KMEANS_RTOL}: {rel:.3g}")
    print(f"# cross-check k-means: 8192 x {EMB_D}, {N_CLUSTERS} clusters, "
          f"{len(swapped)} labels differ, inertia {in_d:.3f} vs {in_c:.3f} "
          f"(rel {rel:.3g}), iterations {it_d} vs {it_c}")
    cross_check_counting(dev)
    cross_check_gbdt(dev)
    cross_check_sgns(dev)


def cross_check_pass_a(dev, sessions, cand, feats):
    """Pass A's programs on the card and on the CPU, from the same batch
    (the retrieval cross-check's card outputs) and seeded labels: packed
    meta, label bits, the per-source eval's counters and report, the
    downsampled rows and their float16 bytes, all bit-equal; the card's
    keep bits hold their semantics."""
    from otto_tpu_torch.config import TYPES, RankerConfig
    from otto_tpu_torch.data.schema import Labels
    from otto_tpu_torch.engine import rank
    from otto_tpu_torch.engine.retrieval import RetrievedBatch, label_keys_device
    from otto_tpu_torch.eval.per_source import DeviceSourceEval

    cpu = torch.device("cpu")
    rng = np.random.default_rng(SEED)
    c = cand.numpy()
    ls, lt, la = [], [], []
    for i, s in enumerate(sessions):
        real = c[i][c[i] >= 0]
        for t in range(3):
            for a in real[rng.random(len(real)) < 0.02 * (t + 1)]:
                ls.append(s), lt.append(t), la.append(a)
            if rng.random() < 0.3:
                ls.append(s), lt.append(t), la.append(N_AIDS + i)
    labels = Labels(np.array(ls), np.array(lt), np.array(la))
    cfg = RankerConfig()
    out = []
    for device in (dev, cpu):
        b = RetrievedBatch(session=sessions, cand=cand.to(device), feats=feats.to(device),
                           ts_order=cand.to(device))
        meta, bits = b.pack_meta_labels(label_keys_device(labels, device))
        ev = DeviceSourceEval(cand.shape[1], device)
        ev.update(meta, bits)
        b.unpack_meta(meta)
        tb = bits.cpu().numpy()
        tgt = np.stack([(tb >> t) & 1 for t in range(3)], -1).astype(np.float32)
        sel = [rank.downsample_select(b, tgt, t, cfg, np.random.default_rng(42))
               for t in range(3)]
        si = np.concatenate([x[0] for x in sel if x is not None])
        ci = np.concatenate([x[1] for x in sel if x is not None])
        rows, _ = b.feats_rows_async(si, ci)
        out.append((meta.cpu(), bits.cpu(), ev.hits.cpu(), ev.hist.cpu(),
                    ev.finalize(labels), sel, rows))
    (m_d, b_d, h_d, hist_d, rep_d, sel_d, rows_d), (m_c, b_c, h_c, hist_c, rep_c, sel_c,
                                                    rows_c) = out
    require(torch.equal(m_d, m_c) and torch.equal(b_d, b_c), "pack meta and label bits bit-equal")
    require(int((b_c & 7).count_nonzero()) > 0, "the labels hit candidates")
    require(torch.equal(h_d, h_c) and torch.equal(hist_d, hist_c) and rep_d == rep_c,
            "per-source eval counters and report bit-equal")
    for t, (x, y) in enumerate(zip(sel_d, sel_c)):
        require((x is None) == (y is None)
                and (x is None or all(np.array_equal(u, v) for u, v in zip(x, y))),
                f"downsample selection type {t} equal")
    require(rows_d.tobytes() == rows_c.tobytes(), "downsampled float16 rows bit-equal")

    # the card's keep bits (its own generator): their semantics
    b = RetrievedBatch(session=sessions, cand=cand.to(dev), feats=feats.to(dev),
                       ts_order=cand.to(dev))
    _, kb = b.pack_meta_labels_select(label_keys_device(labels, dev),
                                      torch.Generator(device=dev).manual_seed(SEED),
                                      cfg.neg_to_pos_ratio, cfg.max_neg_per_session)
    kb = kb.cpu().numpy()
    valid = c >= 0
    require(np.array_equal(kb & 7, b_c.numpy()), "keep program's label bits")
    for t in range(3):
        y, keep = (kb >> t) & 1, (kb >> (3 + t)) & 1
        n_pos = ((y == 1) & valid).sum(1)
        want = np.minimum(np.minimum(cfg.neg_to_pos_ratio * n_pos, cfg.max_neg_per_session),
                          (valid & (y == 0)).sum(1)) * (n_pos > 0)
        require(np.array_equal(((keep == 1) & (y == 0)).sum(1), want)
                and np.array_equal((keep == 1) & (y == 1), (y == 1) & valid & (n_pos > 0)[:, None]),
                f"card keep bits of type {t} keep the positives and min(ratio n_pos, cap) negatives")
    n_rows = len(rows_c)
    print(f"# cross-check pass A: {len(labels)} labels, meta, label bits, per-source "
          f"counters and report, {n_rows} downsampled rows (float16 bytes) bit-equal; "
          f"card keep bits hold their counts ({', '.join(TYPES)})")


def gbdt_case(seed, n_groups=1500, width=104):
    """Seeded ranking rows at the rankers' width: relevance from a few
    features and their interaction, 1-3 positives per group."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(20, 101, n_groups)
    sess = np.repeat(np.arange(n_groups), sizes)
    x = rng.normal(size=(len(sess), width)).astype(np.float16)
    x[:, 10:20] = rng.integers(0, 6, (len(sess), 10))
    logit = x[:, 0].astype(np.float32) + (x[:, 1] > 0.5) * x[:, 12] + rng.normal(size=len(sess))
    y = np.zeros(len(sess), np.int8)
    start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    for g, (a, n) in enumerate(zip(start, sizes)):
        y[a + np.argsort(-logit[a: a + n])[: 1 + g % 3]] = 1
    return x, y, sess


def cross_check_gbdt(dev):
    """GBDT training on the card against the CPU: histograms of the same
    (row bins, nodes, gradients) bit-equal; a few trees grown from one set
    of draws (made on the CPU, copied to both) with equal split features
    and bins up to the first split whose choice differs, which must be a
    near tie (GAIN_RTOL, printed), and leaves within LEAF_TOL; and the same
    training twice on the card, bit-identical."""
    from otto_tpu_torch.config import GBDTConfig
    from otto_tpu_torch.models import gbdt

    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(SEED)
    n, fs = 200_000, 26
    bins = torch.randint(0, 64, (n, fs), generator=g, dtype=torch.uint8)
    bins[:, 0] = bins[:, 0] % 3                       # hot bins
    node = torch.randint(0, 8, (n,), generator=g)
    gh = torch.randn((n, 3), generator=g) * torch.exp(torch.randn((n, 1), generator=g) * 3)
    h_c = gbdt._histograms(bins, node, gh, 8, 64)
    h_d = gbdt._histograms(bins.to(dev), node.to(dev), gh.to(dev), 8, 64).cpu()
    require(torch.equal(h_c, h_d), "GBDT histograms bit-equal")

    x, y, sess = gbdt_case(SEED)
    names = tuple(f"f{i}" for i in range(x.shape[1]))
    cfg = GBDTConfig(n_trees=8, eval_every=4, group_chunk=256)
    u = np.unique(sess)
    vm = np.isin(sess, u[int(len(u) * 0.75):])
    n_rows = len(gbdt._group_slots(y[~vm], sess[~vm], cfg.max_group)[0])
    n_pad = -(-len(np.unique(sess[~vm])) // cfg.group_chunk) * cfg.group_chunk * cfg.max_group
    cpu_draws = gbdt.tree_draws(cfg, x.shape[1], n_pad, cpu)

    def train(device):
        return gbdt.train_gbdt_ranker(
            x[~vm], y[~vm], sess[~vm], names, cfg, valid=(x[vm], y[vm], sess[vm]),
            device=device, draws=lambda t: tuple(a.to(device) for a in cpu_draws(t)))

    m_c, m_d, m_d2 = train(cpu), train(dev), train(dev)
    require(all(np.array_equal(getattr(m_d, k), getattr(m_d2, k))
                for k in ("gfeat", "thr", "leaf", "gains")),
            "two card trainings bit-identical")
    split_c = np.stack([m_c.gfeat, m_c.thr], -1).reshape(cfg.n_trees, -1, 2)
    split_d = np.stack([m_d.gfeat, m_d.thr], -1).reshape(cfg.n_trees, -1, 2)
    same = (split_c == split_d).all(-1).all(-1)
    n_same = cfg.n_trees if same.all() else int(np.argmin(same))
    if n_same < cfg.n_trees:
        gc, gd = m_c.gains[n_same].reshape(-1), m_d.gains[n_same].reshape(-1)
        k = int(np.nonzero((split_c[n_same] != split_d[n_same]).any(-1))[0][0])
        rel = abs(gc[k] - gd[k]) / max(abs(gc[k]), 1e-30)
        print(f"#   tree {n_same} node {k}: card splits on {tuple(split_d[n_same, k])} "
              f"(gain {gd[k]:.7g}), CPU on {tuple(split_c[n_same, k])} (gain {gc[k]:.7g}): "
              f"relative margin {rel:.3g}")
        require(rel <= GAIN_RTOL, f"a differing split is a near tie ({rel:.3g})")
    err = float(np.abs(m_c.leaf[:n_same] - m_d.leaf[:n_same]).max()) if n_same else 0.0
    require(err <= LEAF_TOL, f"GBDT leaves within {LEAF_TOL}: {err:.3g}")
    ndcg = [round(v, 5) for _, v in m_d.eval_history]
    print(f"# cross-check GBDT: histograms of {n} rows x {fs} features bit-equal; "
          f"{cfg.n_trees} trees on {n_rows} rows from the CPU's draws: {n_same} with "
          f"equal splits, leaves max |diff| {err:.3g} (tolerance {LEAF_TOL}), valid ndcg "
          f"card {ndcg} CPU {[round(v, 5) for _, v in m_c.eval_history]}; two card "
          f"trainings bit-identical")


def cross_check_sgns(dev):
    """SGNS on the card against the CPU from the same draws (made on the
    CPU, copied to both) and the same seeded state: one block step (16384
    centers x 4, 8 negatives, 100-d) and one pair step (65536 pairs) with
    their tables and accumulators within SGNS_RTOL / SGNS_ATOL; then two
    card trainings of a small corpus in each step kind, bit-identical."""
    from otto_tpu_torch.config import Word2VecConfig
    from otto_tpu_torch.data.synthetic import SyntheticSpec, generate
    from otto_tpu_torch.models import word2vec as w2v

    cpu = torch.device("cpu")
    n_aids = 50_000
    ev = generate(SyntheticSpec(n_sessions=20_000, n_aids=n_aids, max_len=128,
                                mean_len=14, seed=SEED + 3), cpu)
    vocab = w2v.build_vocab(ev, (0, 1, 2), 2, n_aids)
    words, cum = w2v.flat_corpus(ev, vocab, (0, 1, 2))
    V, N = vocab.size, len(words)
    prob, alias = w2v.make_alias(vocab.counts)
    host = {"words": torch.from_numpy(words).long(), "cum": torch.from_numpy(cum).long(),
            "pos_info": torch.from_numpy(w2v.pack_position_info(cum)).long(),
            "prob": torch.from_numpy(prob), "alias": torch.from_numpy(alias).long(),
            "cdf": torch.from_numpy(w2v.make_neg_cdf(vocab.counts)),
            "keep": torch.from_numpy(w2v.keep_probs(vocab.counts, 1e-3))}
    g = torch.Generator().manual_seed(SEED)
    state = (torch.randn((V, EMB_D), generator=g) * 0.3,
             torch.randn((V, EMB_D), generator=g) * 0.3,
             torch.rand(V, generator=g) + 0.01, torch.rand(V, generator=g) + 0.01)
    block = w2v.block_draws(g, 16384, 4, 10, N, V, 256 * 64)
    pair = w2v.pair_draws(g, 65536, 10, (65536, 8))

    def step(device, kind):
        x = {k: v.to(device) for k, v in host.items()}
        p = w2v.SGNSParams(*(t.to(device).clone() for t in state))
        if kind == "block":
            loss = w2v._block_step(p, x["words"], x["pos_info"], x["prob"], x["alias"],
                                   x["keep"], 0.25, 4, 8,
                                   {k: v.to(device) for k, v in block.items()})
        else:
            loss = w2v._pair_step(p, x["words"], x["cum"], x["cdf"], x["keep"], 0.25,
                                  65536, 8, {k: v.to(device) for k, v in pair.items()},
                                  "pair")
        return [t.cpu() for t in p], float(loss)

    for kind in ("block", "pair"):
        (got, loss_d), (want, loss_c) = step(dev, kind), step(cpu, kind)
        errs = []
        for name, a, b, s0 in zip(w2v.SGNSParams._fields, got, want, state):
            require(torch.allclose(a, b, rtol=SGNS_RTOL, atol=SGNS_ATOL),
                    f"SGNS {kind} step {name} within {SGNS_RTOL} / {SGNS_ATOL}")
            moved = int((b != s0).reshape(V, -1).any(1).sum())
            errs.append(f"{name} {float((a - b).abs().max()):.3g} ({moved} rows moved)")
        require(abs(loss_d - loss_c) <= SGNS_RTOL * abs(loss_c), f"SGNS {kind} loss")
        print(f"# cross-check SGNS {kind} step: V = {V}, card vs CPU max |diff| "
              f"{', '.join(errs)}; loss {loss_d:.6f} vs {loss_c:.6f} (tolerance "
              f"{SGNS_RTOL} relative + {SGNS_ATOL})")

    for sharing in ("chunk", "pair"):
        cfg = Word2VecConfig(name="x", min_count=2, epochs=2, neg_sharing=sharing)
        a, b = (w2v.train_word2vec_device(ev, cfg, n_aids, device=dev) for _ in range(2))
        require(np.array_equal(a.emb, b.emb), f"two card SGNS trainings ({a.report.mode}) "
                "bit-identical")
        print(f"# cross-check SGNS: two card trainings of {V} words, {a.report.mode} steps, "
              f"{a.report.steps_per_epoch} x {a.report.epochs}, bit-identical; losses "
              f"{[round(x, 5) for x in a.report.epoch_loss]}")


def cross_check_counting(dev):
    """Co-visitation tables, popularity tables and the baseline's top-20 of
    ~3k generated sessions, built on the card and on the CPU: bit-equal.
    A small pair budget and run size make the ladder merge, spill and
    (with a low threshold) prune several times."""
    from otto_tpu_torch.config import CoVisConfig, PopularityConfig
    from otto_tpu_torch.data.split import split_events
    from otto_tpu_torch.data.synthetic import SyntheticSpec, generate
    from otto_tpu_torch.engine import baseline
    from otto_tpu_torch.engine.covis import CoVisCounter
    from otto_tpu_torch.engine.popularity import compute_popularity

    cpu = torch.device("cpu")
    n_aids = 20_000
    sp = split_events(generate(SyntheticSpec(
        n_sessions=3000, n_aids=n_aids, max_len=128, mean_len=14, seed=SEED + 2),
        cpu), test_days=7, seed=0)
    cases = (("spill, pruned", dict(spill_prune_min_rows=2_000)),
             ("spill=False", dict(host_spill=False, accumulator_capacity=1 << 15)))
    cpu_tables = {}
    for label, over in cases:
        cfg = dataclasses.replace(CoVisConfig(), pair_budget=1 << 16,
                                  max_run_rows=1 << 19, **over)
        built = []
        for device in (dev, cpu):
            counter = CoVisCounter(cfg, device)
            try:
                counter.update(sp.train)
                counter.update(sp.test)
                tables = counter.retrieval_tables(n_aids)
            finally:
                counter.close()
            built.append((tables, counter.ladder.rows_pruned,
                          counter.ladder.rows_spilled, counter.unique_pairs))
        (t_d, pruned, spilled, uniq), (t_c, *rest) = built
        cpu_tables[label] = t_c
        require([pruned, spilled, uniq] == rest, f"covis {label}: counter stats equal")
        require(pruned > 0 or not cfg.host_spill, f"covis {label}: the prune ran")
        for name in cfg.names:
            for f, a, b in zip(t_d[name]._fields, t_d[name], t_c[name]):
                require(torch.equal(a.cpu(), b), f"covis {label} {name}.{f} bit-equal")
        n_rows = sum(int((t.neighbor[:, 0] >= 0).sum()) for t in t_c.values())
        require(n_rows > 0, f"covis {label}: tables have rows")
        print(f"# cross-check covis ({label}): {len(sp.train) + len(sp.test)} events, "
              f"five tables bit-equal, {n_rows} rows with a neighbour, "
              f"{spilled} rows spilled, {pruned} pruned")

    full = sp.train.concat(sp.test)
    rng = np.random.default_rng(SEED)
    cl = rng.integers(0, N_CLUSTERS, int(full.session.max()) + 1).astype(np.int32)
    for n_clusters, ev_cl in ((N_CLUSTERS, cl[full.session]),
                              (1, np.zeros(len(full), np.int32))):
        got, want = (compute_popularity(full, ev_cl, n_clusters, n_aids,
                                        PopularityConfig(), device, event_budget=1 << 14)
                     for device in (dev, cpu))
        for f, a, b in zip(got._fields, got, want):
            require(torch.equal(a.cpu(), b), f"popularity cl{n_clusters} {f} bit-equal")
    print(f"# cross-check popularity: cl{N_CLUSTERS} and cl1 tables bit-equal")

    t_c = cpu_tables["spill, pruned"]
    tables_d = {n: type(t)(*(x.to(dev) for x in t)) for n, t in t_c.items()}
    s_d, a_d = baseline.recommend(sp.test, tables_d, batch_sessions=512)
    s_c, a_c = baseline.recommend(sp.test, t_c, batch_sessions=512)
    require(np.array_equal(s_d, s_c) and np.array_equal(a_d, a_c),
            "baseline top-20 bit-equal")
    print(f"# cross-check baseline: {len(s_c)} sessions, top-20 bit-equal")


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
    sp, retriever, build_launches = phase_table_build(dev, smi)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        rankers, pa_launches, tr_launches, pa_metrics = phase_training(
            dev, smi, sp, retriever, work)
    torch.cuda.empty_cache()
    serve_launches = phase_main_path(dev, smi, sp, retriever, rankers, pa_metrics)
    del retriever
    torch.cuda.empty_cache()
    phase_cross_check(dev)

    w = WALK
    print(f"# K1 at the tree walk's shape {w['shape']}: {w['ms']:.3f} ms, bound "
          f"{w['bound_ms']:.3f} ms by {w['bound_by']} ({100 * w['bound_ms'] / w['ms']:.0f}% "
          f"of it), twin {w['plain_ms']:.3f} ms, torch.gather {w['library_ms']:.3f} ms; "
          f"launches in the walk: serving {w['launches']['serving']}, training "
          f"{w['launches']['training']} ({smi})")
    # launches on the paths this script drives: the build (K3, K4), pass A,
    # training and serving (K1, K2)
    paths = {k: build_launches[k] + pa_launches[k] + tr_launches[k] + serve_launches[k]
             for k in build_launches}
    sources = {
        # name: (source, TPU kernel it replaces)
        "gather_rows": ("otto_tpu_torch/csrc/gather_rows.cu",
                        "otto_tpu/ops/pallas/gather.py:54"),
        "segmented_scan": ("otto_tpu_torch/csrc/segscan.cu",
                           "otto_tpu/ops/pallas/segscan.py:90"),
        "mips_topk": ("otto_tpu_torch/csrc/mips_topk.cu",
                      "otto_tpu/ops/pallas/mips.py:87"),
        "gather_rows_hbm": ("otto_tpu_torch/csrc/gather_rows_hbm.cu",
                            "otto_tpu/ops/pallas/dma_gather.py:43"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": paths[name], **kernels[name]}
        for name, (src, rep) in sources.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
