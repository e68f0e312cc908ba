#!/usr/bin/env python3
"""Smoke test of otto_tpu_torch, the PyTorch / CUDA port, on one GPU.

    python3 chip_smoke.py

Needs one CUDA device; with none it exits non-zero before doing anything.
Phases, each printed before the last line:

1. Device: the card's name and power limit, as nvidia-smi reports them.
2. Build: compile the port's CUDA kernels (otto_tpu_torch/csrc/*.cu, one
   nvcc per source, all at once) for sm_90a; print the build seconds.
3. Kernel check: K1 (row gather), K2 (segmented scan), K3 (top-k search),
   K4 (table row gather), K5 (the GBDT walk), K6 (HSTU's pointwise
   attention), K7 (retrieval's Stage E features), K8 (Stage D's
   columns), K9 (the MoE experts' grouped product) and K6's softmax form
   against their plain PyTorch twins on the card at the main paths' shapes
   (K1 at the transport sort's and at the GBDT validation walk's, K5 at
   serving's, K6 and its softmax form at two of serving's length buckets,
   K7 at pass B's 2,048 x 512, K8 at its 2,048 x 4,000, K9 at the MoE
   cell's 6 x 65,536 routed rows over 64 experts, both products, after its
   edge segments, with torch._grouped_mm as its library call),
   with CUDA event times of kernel, twin and library call and each
   kernel's bound; then one transport sort of 40 int32 columns
   at [2048, 4096] with K1 reading the columns by pointer, held bit for
   bit to torch.sort plus the twin and to the same sort on the stacked
   columns, the two forms timed in turns.
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
   cluster popularity over 50 clusters and over one, all through a
   Pipeline on a fresh work dir, which writes the artifact cache (printed:
   its bytes and the seconds spent writing it). Prints the counter's
   work and each stage's seconds and peak memory; checks the five tables,
   the losses (finite, falling), every kNN query its own nearest
   neighbour, each model's overlap with the click-to-click neighbours (at
   least 10x chance), the popularity tables and that K3 and K4 were
   launched.
4b. Training from what phase 4 built: the port's pass_a over every test
   session (~121k) with the split's labels (the label join, the
   per-source eval, negative downsampling; each batch's host work on a
   consumer thread while the next batch retrieves; prints sessions/s,
   seconds by phase, rows kept and sessions with a positive per target,
   the ceiling recall and candidates per session), the same pass in turn
   on one thread (its time; every output bit-equal), then three GBDT
   rankers at GBDTConfig()
   defaults (104 features, 150 trees, depth 4, 64 bins) from its rows,
   each with its seconds, trees/s, peak memory and valid ndcg@20 every 25
   trees, which must beat label-blind orders of the same valid groups.
   Prints the recall of the two w2v retrieval sources beside their
   figures on the seeded models of commit ba4da48. Checks that K1 and K2
   ran in pass A and K1 in training.
4c. SGNS's other paths at production width: w2v-1-2 trained one epoch on
   phase 4's events with chunk negatives, in block steps with Adagrad
   (the path of the reference-scale build), in
   block steps with plain SGD (optimizer "sgd", its rate falling as
   otto_tpu's), in fused-accumulator chunk steps (OTTO_W2V_FUSED=1) and in
   chunk steps on the unfused tables (OTTO_W2V_BLOCK=0): a warm-up
   training of each, then SGNS_ROUNDS more in alternating order, each
   timed on its step loop alone (TrainReport.loop_s; the median, least
   and most ms a step, and SGD / Adagrad and fused / chunk round by
   round); the fused training bit-equal to the chunk training there and
   on the cross-check's small corpus (V ~ 30k). SGD's tables are reported (finite or not: otto_tpu notes
   that the summed SGD steps can diverge), not held to a bar.
5. Serving at production width from the built tables and the trained
   rankers: the port's score_pass (retrieval -> scoring -> top-20, batch
   2048, 32 kept aids, 512 candidates) over every test session and
   submit_and_eval, checking that K1 and K2 were launched and printing
   K1's launches by call shape (B, S, P, W); then the
   heuristic baseline over the same sessions on the built co-visitation
   tables; recall@20 per type beside the ceiling and the baseline's. The
   data are synthetic, so the recalls show that the rankers rank, not what
   real data would score; the sessions/s are smoke readings of this one
   run, not a benchmark.
5b. The MLP ranker (ranker_backend "mlp") at RankerConfig() defaults (104
   features, 256-128-64, 128-candidate groups, 256 groups a step, 16
   epochs with early stop 4): three towers trained from phase 4b's
   persisted rows into the same work dir (ranker-mlp-{t}.npz), each with
   its seconds, steps/s, best epoch, peak memory and valid ndcg@20 by
   epoch, whose best must beat the label-blind orders of its own valid
   groups; one train step and one batch's scoring timed; then score_pass
   over every test session with the towers (K1 and K2 launched, no tree
   walk), recall@20 beside the GBDT's, the ceiling and the baseline.
5c. The HSTU ranker (ranker_backend "hstu", HSTUConfig() widths, weights
   drawn from the seed, not trained) serves every test session through
   score_pass: one K6 launch a block a batch, K4 reading the item rows;
   its sessions/s and launch counts are printed.
5d. The MLA + MoE ranker (ranker_backend "mla_moe") at Moonlight-16B-A3B's
   widths with its first three layers (the dense one and two MoE layers),
   weights drawn from the seed at the benchmark's scales, serves the first
   16,384 test sessions through score_pass: one softmax K6 launch a layer
   a batch, two K9 launches a MoE layer's chunk of tokens (require_k9), K4
   reading the item rows; its sessions/s, peak memory and launch counts
   are printed.
7. The batch runner from the cache: Pipeline.run on phase 4's work dir
   (every test session's retrieval kept on the card at once, C14 on the
   host, phase 4b's rankers): tables from the cache bit-equal to phase
   4's, the host ceiling and per-source report within 1e-9 of pass A's
   device report, recall@20 within 1e-9 of phase 5's, the submission's
   re-parse agreeing; prints cache-load, retrieval, host-eval and scoring
   seconds and the peak memory; keeps its C14 reports and submission for
   phase 9.
8. The tool: phase 4's test events and labels written as OTTO JSONL and
   read back by the native parser (equal), then `python -m
   otto_tpu_torch.pipeline.cli run-synthetic --tiny` twice in a
   subprocess on one work dir, on the card by default: recall in (0, 1],
   the second run from the cache (no artifact rewritten, K3 and K4 not
   launched) with identical metrics.
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
   (bit-identical); SGNS: one block step with Adagrad, one with plain SGD
   and one pair step at production width from the same draws (tables and accumulators within a stated
   tolerance) and two card trainings of a small corpus in each step kind
   (bit-identical); the MLP tower at full width and on a small case,
   pointwise and listwise: scores within two bfloat16 ulps and three
   AdamW steps within 1e-4.
9. Multi-device (run before phase 6): the sharded stages on phase 4's
   events and work dir, in ranks started by the spawn method, (a) one rank
   over NCCL and (b) two ranks sharing the card over gloo (data=2, and
   model=2 for SGNS), after a check of every collective they call on the
   card: the sharded co-visitation counter (five tables bit-equal to phase
   4's), kNN tables (K3) and session embeddings (K4) from phase 4's models
   (bit-equal), dp k-means seeded as kmeans_fit seeds (labels bit-equal),
   sharded popularity from phase 4's clusters (bit-equal), w2v-1-2
   model-parallel in chunk steps for one epoch ((b) bit-equal to (a)), dp
   GBDT for clicks from phase 4b's rows with its default draws (one
   device's: its first 25 trees bit-equal to phase 4b's), data-sharded
   serving of every test session with phase 4b's rankers (K1, K2; top-20
   and recall@20 bit-equal to phase 5's), pass A over the sharded
   retriever (K1, K2; each batch's negatives drawn where one device draws
   them: metrics equal to phase 4b's, reports equal to 4b's and (b)'s to
   (a)'s, rows bit-equal to 4b's on one rank and on two), and the batch
   runner on the mesh, Pipeline(mesh=).run, on a work dir holding phase
   4's tables and phase 4b's GBDT rankers (K1, K2; every test session at
   production width, each rank keeping its own batches: C14 reports and
   submission byte-equal to phase 7's, metrics equal). Prints seconds per
   stage beside the unsharded phases', the batch runner's seconds by step
   beside phase 7's, each rank's K1-K4 launches and peak memory per
   stage; (b) shares one card, so its times are no scaling figure.

10. The reference-scale script, scripts/run_fullscale_torch.py, in a
   subprocess on the card at 30,000 sessions and 50,000 aids
   (Config()'s full width) in a work dir of its own: exit 0, its record
   complete (every stage of Pipeline.run_streaming by otto_tpu's name with
   its seconds, host RSS and peak device memory, the card's name, the
   metrics and the per-source report), K1-K4 launched, and ranked
   recall@20 above the heuristic baseline's on the same test sessions and
   co-visitation tables. It runs with OTTO_FS_TMPFS set (a directory under
   /dev/shm where there is one): the events and the seven tables must be
   written there and linked from the work dir, and every stage's entry
   must carry the bytes on disk, in the tmpfs dir and written.

Every phase that retrieves on the card checks one K7 launch and one K8
column launch a batch it retrieved there. Phases 4, 4b, 5, 5b, 7, 8 and 9
share one work dir; phase 10 runs after phase 9 in a work dir of its own;
phase 6 runs last. Then one JSON line with the kernels' results and,
last, the result line {"ok": true, "device": {...}}. Any failed check
raises: the exit code is then non-zero and the result line is not
printed."""
import contextlib
import dataclasses
import hashlib
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

SEED = 1234
N_AIDS = 1_800_000
# phase 4c: timed trainings of each SGNS step kind after its warm-up
SGNS_ROUNDS = 3
BATCH = 2048
N_SESSIONS = 500_000
EMB_D = 100
KNN_K = 20
KNN_QUERIES = 600_000      # knn_first_n_aids
N_CLUSTERS = 50
# the transport sort's K1 call in phase 3: 40 int32 columns of
# [BATCH, 4096] session rows
SORT_B, SORT_C = 40, 4096

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
BF16_FLOPS = 989e12
# K7 against its twin (phase 3): cos_sim_ses_aid and eucl_dist_ses_aid sum
# a 100-wide dot product and two norms in the kernel's order (the twin's
# in cuBLAS's and linalg.norm's): float32 rounding, as tests/test_torch_
# retrieval.py holds the port to otto_tpu (FLOAT_RTOL, FLOAT_ATOL)
K7_RTOL = K7_ATOL = 1e-5
# K6 against its twin (phase 3): a bound on the largest difference, as a
# share of the twin's largest value. The kernel sums Q.K in its own order,
# so an A near a bfloat16 rounding can round one step (2^-8) the other way;
# a term A v is at most about y's largest value, and a few flips may meet
# in one y
K6_TOL = 5e-3


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
# the unsharded stages' seconds (phases 4, 4b and 5), beside phase 9's
UNSHARDED = {}


def kernel_modules():
    """The wrapper modules of K1-K9, each with its LAUNCHES counter."""
    from otto_tpu_torch.ops.kernels import (dma_gather, gather, gbdt_walk, grouped_gemm,
                                            hstu_attention, mips, retrieval_columns,
                                            retrieval_features, segscan, softmax_attention)

    return (gather, segscan, mips, dma_gather, gbdt_walk, hstu_attention, retrieval_features,
            retrieval_columns, grouped_gemm, softmax_attention)


def zero_launch_counts():
    for m in kernel_modules():
        m.LAUNCHES.reset()


def launch_counts():
    """{kernel: launches}, named by the counter's last part."""
    return {m.LAUNCHES.name.rsplit(".", 1)[1]: m.LAUNCHES.value for m in kernel_modules()}


@contextlib.contextmanager
def batches_retrieved():
    """Count the retrieve_batch calls made meanwhile, from any thread, on
    CUDA inputs (Retriever.iter_run calls it through its module): each is
    one K7 launch and one K8 column launch. Yields a one-element list
    holding the count."""
    import threading

    from otto_tpu_torch.engine import retrieval

    n, lock, inner = [0], threading.Lock(), retrieval.retrieve_batch

    def call(padded, *args, **kwargs):
        out = inner(padded, *args, **kwargs)
        if padded[0].device.type == "cuda":
            with lock:
                n[0] += 1
        return out

    retrieval.retrieve_batch = call
    try:
        yield n
    finally:
        retrieval.retrieve_batch = inner


def require_k7(launches, n_batches, where):
    require(launches["retrieval_features"] == n_batches > 0,
            f"one K7 launch a batch retrieved on the card ({where}): "
            f"{launches['retrieval_features']} launches, {n_batches} batches")


def require_k8(launches, n_batches, where):
    require(launches["retrieval_columns"] == n_batches > 0,
            f"one K8 column launch a batch retrieved on the card ({where}): "
            f"{launches['retrieval_columns']} launches, {n_batches} batches")


def require_k9(launches, routed_chunks, where):
    """Two K9 launches (gate and up, then down) for every chunk of tokens
    that a MoE layer routed."""
    require(launches["grouped_gemm"] == 2 * routed_chunks > 0,
            f"two K9 launches a MoE layer's chunk ({where}): {launches['grouped_gemm']} "
            f"launches, {routed_chunks} routed chunks")


@contextlib.contextmanager
def k1_calls(path):
    """Count the K1 launches made meanwhile, from any thread, through
    gather_rows's only callers, ops/segment.py (every transport sort) and
    models/gbdt.py (the GBDT tree walk): each call on CUDA tensors with a
    non-empty output is one launch. Yields {(B, S, P, W): launches} of
    both callers and sets WALK["launches"][path] to the walk's. Counted
    per call, so what other code launches meanwhile never enters."""
    import threading

    from otto_tpu_torch.models import gbdt
    from otto_tpu_torch.ops import segment

    hist, walk = {}, WALK.setdefault("launches", {})
    walk[path] = 0
    lock = threading.Lock()
    inner = {m: m.gather_rows for m in (segment, gbdt)}

    def counted(m, fn):
        def call(values, idx, check=False):
            out = fn(values, idx, check)
            if idx.device.type == "cuda" and out.numel():
                key = (out.shape[0], out.shape[1], values[0].shape[-1], out.shape[2])
                with lock:
                    hist[key] = hist.get(key, 0) + 1
                    walk[path] += m is gbdt
            return out
        return call

    for m, fn in inner.items():
        m.gather_rows = counted(m, fn)
    try:
        yield hist
    finally:
        for m, fn in inner.items():
            m.gather_rows = fn


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
    from otto_tpu_torch.ops.kernels import dma_gather, gather, gbdt_walk, mips, segscan

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

    # K1: transport-sort shape (columns moved through a row permutation,
    # W = P) and the GBDT tree-walk shape (W = T = 150 > P = F, one level of
    # one ranker on a 2048-session batch), each with its bound and one
    # torch.gather; float32 as random 32-bit words (NaN payloads included),
    # compared as int32 words
    for B, S, P, W, perm in ((SORT_B, BATCH, SORT_C, SORT_C, True),
                             (1, BATCH * 512, 104, 150, False)):
        if perm:
            idx = torch.argsort(torch.rand((S, P), generator=g, device=dev),
                                dim=1).to(torch.int32)
        else:
            idx = torch.randint(0, P, (S, W), generator=g, device=dev,
                                dtype=torch.int32)
        for dtype in (torch.int32, torch.float32):
            v = torch.randint(-2**31, 2**31 - 1, (B, S, P), generator=g,
                              device=dev, dtype=torch.int32).view(dtype)
            got = gather.gather_rows(v, idx, check=True)
            want = gather.gather_rows_ref(v, idx)
            torch.cuda.synchronize()
            require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                    f"K1 {dtype} {(B, S, P, W)} bit-equal")
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
    transport_sort_forms(dev, g, smi)

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
    del ids

    # K5: one ranker's walk on a 2,048-session batch (BATCH x 512 rows of
    # 104 features; 150 trees of depth 4 over 64 bins, a tenth of the
    # splits no-ops), against the twin (searchsorted, the walk on K1, a
    # float32 sum); bit-equal to the twin's leaves summed in float64 in
    # the kernel's order; bound by the features read once and the scores written
    # once (the trees' few kB besides); no one PyTorch call walks trees
    from otto_tpu_torch.models import gbdt

    M, F, T, D, n_bins = BATCH * 512, 104, 150, 4, 64
    edges = torch.sort(torch.randn((F, n_bins - 1), generator=g, device=dev) * 3,
                       dim=1).values
    gfeat = torch.randint(0, F, (T, D, 2 ** (D - 1)), generator=g, device=dev,
                          dtype=torch.int32)
    thr = torch.randint(1, n_bins, gfeat.shape, generator=g, device=dev, dtype=torch.int32)
    thr[torch.rand(gfeat.shape, generator=g, device=dev) < 0.1] = n_bins
    leaf = 0.1 * torch.randn((T, 2 ** D), generator=g, device=dev)
    x = torch.randn((M, F), generator=g, device=dev) * 4
    got = gbdt_walk.gbdt_walk(x, edges, gfeat, thr, leaf)
    val = gbdt._leaf_values(gbdt._bin_program(x, edges), gfeat, thr, leaf)
    acc = torch.zeros(M, dtype=torch.float64, device=dev)
    for a, b in gbdt_walk.leaf_sum_order(T):
        run = torch.zeros_like(acc)
        for t in range(a, b):
            run += val[:, t].double()
        acc += run
    torch.cuda.synchronize()
    require(torch.equal(got, acc.float()), "K5 equals the twin's leaves summed in float64")
    err = float((got - val.sum(dim=1)).abs().max())
    del val, acc
    ms = cuda_ms(lambda: gbdt_walk.gbdt_walk(x, edges, gfeat, thr, leaf))
    plain = cuda_ms(lambda: gbdt._predict_program(x, edges, gfeat, thr, leaf), reps=3)
    n_bytes = 4 * (M * F + M + edges.numel() + gfeat.numel() + thr.numel() + leaf.numel())
    report("gbdt_walk", (M, F, T, D), err, ms, plain, (*bound(n_bytes), None))
    print(f"#   {4 * M * F / (ms * 1e-3) / 1e9:.1f} GB/s of features, "
          f"{M * T * D / (ms * 1e-3) / 1e9:.1f} G tree levels/s")
    del x, got

    # K6: HSTU's pointwise attention on 2,048-session batches of the pass-B
    # cells' shapes (4 heads of 64): histories of 0-30 events and 0-330
    # candidates (~180 tokens a session, at most one 64-key tile), and the
    # 128 length bucket's, histories of 33-128 events and 140-165
    # candidates (a second key tile; history query tiles whose last row is
    # below L). q, k and v are views of one buffer as the ranker hands
    # them over; each against the twin (rows in chunks over the padded
    # history keys), within K6_TOL of it. Bound: the larger of Q, K, V read
    # and Y written once at HBM's rate and the open pairs' two products at
    # the dense bfloat16 peak. No PyTorch call computes SiLU attention (its
    # attention kernels normalise with softmax)
    from otto_tpu_torch.ops.kernels import hstu_attention as k6

    S6, H6 = BATCH, 4
    for l_lo, l_hi, c_lo, c_hi in ((0, 30, 0, 330), (33, 128, 140, 165)):
        L6 = torch.randint(l_lo, l_hi + 1, (S6,), generator=g, device=dev)
        C6 = torch.randint(c_lo, c_hi + 1, (S6,), generator=g, device=dev)
        off = torch.zeros(S6 + 1, dtype=torch.int32, device=dev)
        off[1:] = torch.cumsum(L6 + C6, 0).int()
        N6 = int(off[-1])
        buf = (torch.randn(N6, 3 * H6 * 64, generator=g, device=dev) * 0.7).bfloat16()
        q, k, v = (buf[:, i * H6 * 64:(i + 1) * H6 * 64].view(N6, H6, 64) for i in range(3))
        ts6 = torch.randint(0, 2_400_000, (N6,), generator=g, device=dev, dtype=torch.int32)
        args = (q, k, v, off, L6.int(), ts6, torch.randn(201, generator=g, device=dev),
                torch.randn(129, generator=g, device=dev), k6.time_bucket_thresholds(128, dev),
                200.0)
        k6.check_layout(off, args[4], N6, 201)
        got = k6.hstu_attention(*args)
        want = k6.hstu_attention_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(err <= K6_TOL * float(want.abs().max()),
                f"K6 within {K6_TOL} of the twin at L {l_lo}-{l_hi}: {err}")
        ms = cuda_ms(lambda: k6.hstu_attention(*args))
        plain = cuda_ms(lambda: k6.hstu_attention_ref(*args), reps=3)
        Lk, Ck = L6.long(), C6.long()
        pairs = int((Lk * (Lk + 1) // 2 + Ck * (Lk + 1)).sum())
        n_bytes = (2 * N6 * H6 * 192 + 4 * N6 + 12 * (S6 + 1) + 4 * 201 + 12 * 129
                   + 4 * N6 * H6 * 64)
        by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        by_ops = 2 * pairs * H6 * 128 / BF16_FLOPS * 1e3
        head = (by_bytes, "bytes", None) if by_bytes >= by_ops else (by_ops, "operations", None)
        report(f"hstu_attention L{l_lo}-{l_hi}", (S6, N6, H6, 64), err, ms, plain, head)
        print(f"#   {n_bytes / (ms * 1e-3) / 1e9:.1f} GB/s of q, k, v and y, "
              f"{2 * pairs * H6 * 128 / (ms * 1e-3) / 1e12:.2f} TFLOP/s over the open pairs")
        del buf, q, k, v, got, want, args
    retrieval_columns_check(report, retrieval_features_check(dev, report))
    mla_moe_kernels_check(dev, report)
    return out


# K9 against its twin (phase 3): the kernel sums each output's K products in
# its own order, so a float32 output differs from the twin's by float32
# rounding (~1e-6 of the largest); a bfloat16 output (gate_up form) may round
# one step (2^-8 of its size) the other way where the float32 value lies near
# a rounding
K9_TOL = {"gate_up": 8e-3, "down": 1e-4}
# K6's softmax form against its twin: the kernel rounds the unnormalised
# weights to bfloat16 where the twin rounds the normalised ones (each 2^-9 of
# a term), and a history row's first key is its whole output
K6S_TOL = 1e-2


def k9_case(dev, g, R, E, K, N, gate_up, counts=None):
    """Sorted rows over E experts (drawn counts, or `counts`), a gathered
    A and the weights of one K9 call, as the MoE layer hands them over."""
    from otto_tpu_torch.ops.kernels import grouped_gemm as k9

    if counts is None:
        eid = torch.randint(0, E, (R,), generator=g, device=dev)
        counts = torch.bincount(eid, minlength=E)
    counts = torch.as_tensor(counts, device=dev)
    offsets = torch.zeros(E + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    R = int(offsets[-1])
    N_w = 2 * N if gate_up else N
    a = (torch.randn((max(R // 4, 1) if gate_up else R, K), generator=g, device=dev)).bfloat16()
    w = (torch.randn((E, N_w, K), generator=g, device=dev) * K ** -0.5).bfloat16()
    if gate_up:
        rows = torch.randint(0, a.shape[0], (R,), generator=g, device=dev, dtype=torch.int32)
        return dict(a=a, w=w, offsets=offsets, rows=rows, gate_up=True), k9
    out_rows = torch.randperm(R, generator=g, device=dev).int()
    scale = torch.rand(R, generator=g, device=dev) * 2.446
    out = torch.zeros((R, N), device=dev)
    return dict(a=a, w=w, offsets=offsets, out_rows=out_rows, row_scale=scale, out=out), k9


def mla_moe_kernels_check(dev, report):
    """K9 (the grouped expert product) and K6's softmax form at the MoE
    ranker's widths. K9: edge segments (an empty expert, one expert holding
    every row, counts not a multiple of a tile) against the twin, then the
    cell's shape, 6 x 65,536 routed rows over 64 experts, 2048 -> 2 x 1408
    (gate_up, rows gathered) and 1408 -> 2048 (rows scaled and scattered),
    with its bound (the larger of its FLOPs at the dense bfloat16 peak and
    its bytes: rows in, every expert's weights once, rows out) and
    torch._grouped_mm on the gathered rows as the library column. K6
    softmax: 2,048 sessions of the 32 and the 128 length buckets' shapes
    (16 heads, q and k 192 wide, v 128), against the twin, with its bound.
    -> (K9's gate_up ms, its library ms)."""
    from otto_tpu_torch.ops.kernels import softmax_attention as k6s

    g = torch.Generator(device=dev).manual_seed(SEED)
    for gate_up in (True, False):
        form = "gate_up" if gate_up else "down"
        for counts in ([0, 300, 0, 0, 1, 129, 0, 70], [0, 0, 0, 1000, 0, 0, 0, 0]):
            kw, k9 = k9_case(dev, g, 0, 8, 256, 128, gate_up, counts)
            got = k9.grouped_gemm(**dict(kw, out=kw["out"].clone()) if "out" in kw else kw)
            want = k9.grouped_gemm_ref(**dict(kw, out=kw["out"].clone()) if "out" in kw
                                       else kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            require(err <= K9_TOL[form] * float(want.float().abs().max()),
                    f"K9 {form} within {K9_TOL[form]} of the twin at counts {counts}: {err}")
    lib_ms = None
    for gate_up, K, N in ((True, 2048, 1408), (False, 1408, 2048)):
        form = "gate_up" if gate_up else "down"
        R = 6 * 65536
        kw, k9 = k9_case(dev, g, R, 64, K, N, gate_up)
        fresh = (lambda: dict(kw, out=torch.zeros_like(kw["out"]))) if "out" in kw \
            else (lambda: kw)
        got = k9.grouped_gemm(**fresh())
        want = k9.grouped_gemm_ref(**fresh())
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        require(err <= K9_TOL[form] * float(want.float().abs().max()),
                f"K9 {form} within {K9_TOL[form]} of the twin at the cell's shape: {err}")
        del got, want
        args = fresh()
        ms = cuda_ms(lambda: k9.grouped_gemm(**args))
        plain = cuda_ms(lambda: k9.grouped_gemm_ref(**args), reps=2)
        N_w = 2 * N if gate_up else N
        flops = 2 * R * N_w * K
        n_bytes = (2 * R * K + 2 * 64 * N_w * K + 8 * 65 + (4 if gate_up else 8) * R
                   + (2 * R * N if gate_up else 4 * R * N))
        by_ops, by_bytes = flops / BF16_FLOPS * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
        lib = None
        if hasattr(torch, "_grouped_mm"):
            a = kw["a"][kw["rows"].long()] if gate_up else kw["a"]
            wt = kw["w"].transpose(1, 2)
            ends = kw["offsets"][1:].contiguous()
            try:
                torch._grouped_mm(a, wt, offs=ends)
                lib = cuda_ms(lambda: torch._grouped_mm(a, wt, offs=ends))
            except (RuntimeError, TypeError) as e:
                print(f"#   torch._grouped_mm refused the shape: {e}")
        if gate_up:
            lib_ms = lib
        head = (by_ops, "operations", lib) if by_ops >= by_bytes else (by_bytes, "bytes", lib)
        report(f"grouped_gemm {form}", (R, 64, K, N_w), err, ms, plain, head)
        print(f"#   {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s"
              + ("" if lib is None else f"; torch._grouped_mm {flops / (lib * 1e-3) / 1e12:.1f} "
                 "TFLOP/s on the rows gathered beforehand"))
        del kw, args
        torch.cuda.empty_cache()

    S6, H6 = BATCH, 16
    for l_lo, l_hi, c_lo, c_hi in ((0, 30, 0, 330), (33, 128, 140, 165)):
        L6 = torch.randint(l_lo, l_hi + 1, (S6,), generator=g, device=dev)
        C6 = torch.randint(c_lo, c_hi + 1, (S6,), generator=g, device=dev)
        off = torch.zeros(S6 + 1, dtype=torch.int32, device=dev)
        off[1:] = torch.cumsum(L6 + C6, 0).int()
        N6 = int(off[-1])
        q = torch.randn((N6, H6, 192), generator=g, device=dev).bfloat16()
        k = torch.randn((N6, H6, 192), generator=g, device=dev).bfloat16()
        v = (torch.randn((N6, H6, 128), generator=g, device=dev) * 0.7).bfloat16()
        args = (q, k, v, off, L6.int(), 192 ** -0.5)
        got = k6s.softmax_attention(*args)
        want = k6s.softmax_attention_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(err <= K6S_TOL * float(want.abs().max()),
                f"K6 softmax within {K6S_TOL} of the twin at L {l_lo}-{l_hi}: {err}")
        del got, want
        ms = cuda_ms(lambda: k6s.softmax_attention(*args))
        plain = cuda_ms(lambda: k6s.softmax_attention_ref(*args), reps=1)
        Lk, Ck = L6.long(), C6.long()
        pairs = int((Lk * (Lk + 1) // 2 + Ck * (Lk + 1)).sum())
        n_bytes = 2 * N6 * H6 * (2 * 192 + 128) + 12 * (S6 + 1) + 4 * N6 * H6 * 128
        by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        by_ops = 2 * pairs * H6 * 320 / BF16_FLOPS * 1e3
        head = (by_bytes, "bytes", None) if by_bytes >= by_ops else (by_ops, "operations", None)
        report(f"softmax_attention L{l_lo}-{l_hi}", (S6, N6, H6, 192), err, ms, plain, head)
        del q, k, v, args
    return lib_ms


def retrieval_features_check(dev, report):
    """K7 at the pass-B shape: one retrieve_batch of BATCH sessions of the
    32 length bucket on seeded tables of N_AIDS aids at production width
    (32 kept aids, 512 slots), its Stage E inputs caught and run through
    the kernel and through the twin: candidates, ts_order and every
    feature bit-equal but the two similarity ones (within K7_RTOL), the
    CUDA event times of both, and the kernel's bound: the bytes these
    inputs need at HBM's rate (every slot's sort key and outputs, the two
    moved columns of a filled slot, the other 80 columns, the item row and
    three popularity ranks of a valid one, the session stats and
    embeddings once). No one PyTorch call computes the features."""
    from otto_tpu_torch.config import RetrievalConfig
    from otto_tpu_torch.data.batching import pack_sessions
    from otto_tpu_torch.data.synthetic import SyntheticSpec, generate_device
    from otto_tpu_torch.engine import retrieval
    from otto_tpu_torch.ops.kernels import retrieval_features as k7

    cfg = RetrievalConfig()
    ev = generate_device(SyntheticSpec(n_sessions=8000, n_aids=N_AIDS, max_len=32,
                                       mean_len=14, seed=SEED), dev)
    p = pack_sessions(ev, (32,))[0]
    require(p.n_sessions >= BATCH, f"{BATCH} sessions in the 32 bucket: {p.n_sessions}")
    ctx = seeded_context(N_AIDS, dev, SEED)
    cluster, semb = session_lookup(ev, SEED).lookup(p.session[:BATCH])

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x[:BATCH])).to(dev)

    trim = torch.tensor([cfg.trim_max_at_order_1, cfg.trim_min,
                         (cfg.trim_max_at_order_1 - cfg.trim_min) / (cfg.trim_min_at_order - 1)],
                        dtype=torch.float32, device=dev)
    caught, caught_d = [], []
    stage_e, stage_d = retrieval._stage_e, retrieval._stage_d
    with mock.patch.object(retrieval, "_stage_e", lambda *a: caught.append(a) or stage_e(*a)), \
            mock.patch.object(retrieval, "_stage_d",
                              lambda *a: caught_d.append(a) or stage_d(*a)):
        retrieval.retrieve_batch((put(p.aid), put(p.ts), put(p.type)), ctx, put(cluster),
                                 put(semb), trim, cfg.max_session_aids, cfg.max_candidates)
    args = caught[0]
    pk = args[0]
    got = stage_e(*args)
    want = retrieval._features_program(*args)
    torch.cuda.synchronize()
    require(torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]),
            "K7 candidates and ts_order equal to the twin's")
    sim = [retrieval.FEATURE_INDEX[n] for n in ("cos_sim_ses_aid", "eucl_dist_ses_aid")]
    words, words_t = got[1].view(torch.int32), want[1].view(torch.int32)
    off = [n for j, n in enumerate(retrieval.FEATURE_NAMES)
           if j not in sim and not torch.equal(words[..., j], words_t[..., j])]
    require(not off, f"K7 features bit-equal to the twin's: {off} differ")
    a, b = got[1][..., sim], want[1][..., sim]
    err = float((a - b).abs().max())
    require(bool(torch.allclose(a, b, rtol=K7_RTOL, atol=K7_ATOL)),
            f"K7 similarity features within {K7_RTOL} of the twin's: {err}")
    ms = cuda_ms(lambda: stage_e(*args), reps=20)
    plain = cuda_ms(lambda: retrieval._features_program(*args), reps=3)
    S, C = pk.shape
    filled = int((pk != retrieval.SENT).sum())
    valid = int((got[0] >= 0).sum())
    D = ctx.aid_emb.shape[1]
    n_bytes = (4 * S * C + 4 * 2 * filled + 4 * (len(k7.COLUMNS) - 2 + D + 3) * valid
               + 4 * S * (len(k7.STATS) + D)
               + 4 * S * cfg.max_candidates * (k7.N_FEATURES + 2))
    report("retrieval_features", (S, C, k7.N_FEATURES), err, ms, plain,
           (*bound(n_bytes), None))
    print(f"#   {n_bytes / (ms * 1e-3) / 1e9:.1f} GB/s; {valid} valid of {S * C} slots "
          f"({filled} filled); all {S * C} slots read in full would be "
          f"{bound(4 * S * C * (len(k7.COLUMNS) + 1 + D + 3 + k7.N_FEATURES + 2))[0]:.3f} ms")
    return caught_d[0]


def retrieval_columns_check(report, args):
    """K8 at the pass-B shape, on the Stage D inputs of the batch
    retrieval_features_check retrieves (2,048 sessions of the 32 bucket, 32 kept aids: 3,872
    level-1 lanes and 128 popularity slots): its key launch and, after the
    key sort, its column launch against the twin, key2 and every column at
    every sorted lane bit-equal (the twin's columns moved to sort order);
    CUDA event times of K8's two launches and of what they replace (the
    twin and its columns' transport sort on K1); the bound: the bytes the
    two launches need at HBM's rate (every lane's key, index, flags and
    columns written; a kept level-1 lane's 13 trim words and 47 column
    words, a popularity slot's ranks)."""
    from otto_tpu_torch.engine import retrieval
    from otto_tpu_torch.ops import segment
    from otto_tpu_torch.ops.kernels import retrieval_columns as k8

    ks1, red1, end1, min_ts, cluster, ctx, trim = args
    inputs = [red1[n] for n in k8.INPUTS]

    def keys():
        return k8.retrieval_keys(ks1, end1, inputs, trim, cluster, ctx.pop_cl50_cand,
                                 ctx.pop_cl50_ranks)

    key2, flags = keys()
    key2_t, cols = retrieval._columns_program(*args)
    require(torch.equal(key2, key2_t), "K8 key2 equal to the twin's")
    ks2, perm = torch.sort(key2, dim=-1, stable=True)

    def columns():
        return k8.retrieval_columns(ks2, perm, flags, inputs, min_ts, cluster,
                                    ctx.pop_cl50_ranks)

    groups, first, is_end = columns()
    got = torch.cat(groups[:-1] + [groups[-1].view(torch.int32)])
    want = torch.stack([torch.gather(cols[n][0], 1, perm).view(torch.int32)
                        for n in k8.COLUMNS])
    torch.cuda.synchronize()
    off = [n for j, n in enumerate(k8.COLUMNS) if not torch.equal(got[j], want[j])]
    require(not off, f"K8 columns bit-equal to the twin's in sort order: {off} differ")
    require(torch.equal(first, ks2 != segment._prev(ks2, segment.NEG_SENTINEL))
            and torch.equal(is_end, segment._next(first, True) & (ks2 != segment.SENTINEL)),
            "K8 segment flags equal to the sorted keys'")
    del got, want

    def twin():
        key2_p, cols_p = retrieval._columns_program(*args)
        return segment.rowwise_transport_sort(key2_p, [c for c, _ in cols_p.values()])

    ms = cuda_ms(lambda: (keys(), columns()), reps=20)
    ms_keys = cuda_ms(keys, reps=20)
    plain = cuda_ms(twin, reps=3)
    S, P1 = ks1.shape
    P2 = ks2.shape[1]
    T, K = ctx.pop_cl50_ranks.shape[1:]
    valid = int(end1.sum())
    kept = int((key2[:, :P1] != retrieval.SENT).sum())
    pop = int((key2[:, P1:] != retrieval.SENT).sum())
    n_bytes = (5 * S * P1 + 4 * 13 * valid + 4 * S * T * (1 + K) + 4 * S * P2 + S * P1
               + (4 + 8 + 2 + 4 * len(k8.COLUMNS)) * S * P2 + (1 + 4 * 47) * kept
               + 4 * k8.N_POP * pop + 8 * S)
    report("retrieval_columns", (S, P2, len(k8.COLUMNS)), 0.0, ms, plain,
           (*bound(n_bytes), None))
    print(f"#   {n_bytes / (ms * 1e-3) / 1e9:.1f} GB/s; key launch {ms_keys:.3f} ms, column "
          f"launch {ms - ms_keys:.3f} ms; {valid} level-1 entries, {kept} kept, {pop} "
          f"popularity candidates of {S * P2} sorted lanes")


def transport_sort_forms(dev, g, smi):
    """One rowwise_transport_sort of SORT_B int32 columns at [BATCH,
    SORT_C] (the sort's shape in phase 3) as the port runs it, K1 reading
    the columns by pointer, against torch.sort and the plain twin on the
    same columns, and against the same sort with the columns first stacked
    into one tensor (what the sort did before): outputs bit-equal, CUDA
    event times of the two forms taken in turns (stacked, list, list,
    stacked)."""
    from otto_tpu_torch.ops import segment
    from otto_tpu_torch.ops.kernels import gather

    B, S, C = SORT_B, BATCH, SORT_C
    key = torch.randint(0, 1000, (S, C), generator=g, device=dev, dtype=torch.int32)
    cols = [torch.randint(-2**31, 2**31 - 1, (S, C), generator=g, device=dev,
                          dtype=torch.int32) for _ in range(B)]

    def stacked():
        ks, perm = torch.sort(key, dim=-1, stable=True)
        return ks, gather.gather_rows(torch.stack(cols), perm.to(torch.int32))

    def listed():
        return segment.rowwise_transport_sort(key, cols)

    ks, perm = torch.sort(key, dim=-1, stable=True)
    plain = gather.gather_rows_ref(cols, perm)
    (ka, a), (kb, b) = stacked(), listed()
    require(torch.equal(ks, kb) and all(torch.equal(plain[i], b[i]) for i in range(B)),
            "transport sort: list form equal to torch.sort and the plain twin")
    require(torch.equal(ka, kb) and all(torch.equal(a[i], b[i]) for i in range(B)),
            "transport sort: list form equal to the stacked form")
    del a, b, plain, perm
    times = [cuda_ms(fn) for fn in (stacked, listed, listed, stacked)]
    st, ls = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
    print(f"# rowwise_transport_sort {B} int32 columns at {[S, C]}: stacked then K1 "
          f"{times[0]:.3f} / {times[3]:.3f} ms, columns by pointer {times[1]:.3f} / "
          f"{times[2]:.3f} ms (in turns; means {st:.3f} vs {ls:.3f} ms, "
          f"{st - ls:.3f} ms saved a sort) ({smi})")


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


def phase_table_build(dev, smi, work):
    """The build through a Pipeline on `work`, which it leaves holding the
    artifact cache. -> (split, retriever, launches)."""
    from otto_tpu_torch.config import COVIS_FIRST_N, W2VEC_MODELS, Config, RetrievalConfig
    from otto_tpu_torch.data.batching import pack_sessions
    from otto_tpu_torch.data.split import split_events
    from otto_tpu_torch.data.synthetic import SyntheticSpec, generate_device
    from otto_tpu_torch.pipeline.runner import Pipeline

    t0 = time.perf_counter()
    spec = SyntheticSpec(n_sessions=N_SESSIONS, n_aids=N_AIDS, max_len=512,
                         mean_len=18, seed=SEED)
    sp = split_events(generate_device(spec, dev), test_days=7, seed=0)
    cfg = RetrievalConfig()
    buckets = {p.max_len: p.n_sessions
               for p in pack_sessions(sp.test, cfg.session_len_buckets)}
    n_test = int(np.unique(sp.test.session).size)
    print(f"# data: {len(sp.train)} train and {len(sp.test)} test events, "
          f"{n_test} test sessions, buckets {buckets}, "
          f"{time.perf_counter() - t0:.1f} s")
    require(set(buckets) == set(cfg.session_len_buckets), "all four buckets run")

    pipe = Pipeline(Config(retrieval=cfg), work, N_AIDS, device=dev)
    zero_launch_counts()
    t0 = time.perf_counter()
    retriever = pipe.build_retriever(sp.train, sp.test)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    rep = pipe.build_report
    peak = max(rep.peak_bytes.values())
    cache = rep.cache
    print(f"# table build: {dt:.2f} s ({dt - cache['write_seconds']:.2f} s without the "
          f"cache writes), peak {peak / 2**30:.2f} GiB allocated, launches {launches} ({smi})")
    print(f"# artifact cache: {cache['bytes'] / 1e9:.3f} GB in {len(cache['written'])} "
          f"files written in {cache['write_seconds']:.2f} s: {cache['written']}")
    require(not cache["loaded"] and len(cache["written"]) == 7,
            f"a fresh work dir: every artifact built and written ({cache})")
    for stage, s in rep.seconds.items():
        extra = ""
        if stage.startswith("knn "):
            q = min(KNN_QUERIES, rep.w2vec[stage[4:]].words)
            v = rep.w2vec[stage[4:]].words
            extra = (f" ({q} queries x {v} x {EMB_D}: "
                     f"{2 * q * v * EMB_D / s / 1e12:.2f} TFLOP/s)")
        print(f"#   {stage}: {s:.3f} s, peak {rep.peak_bytes[stage] / 2**30:.2f} GiB{extra}")
    report_w2vec(rep, smi)
    UNSHARDED["covis"] = rep.seconds["covis count"] + rep.seconds["covis tables"]
    for stage in ("session_emb", "kmeans", "popularity"):
        UNSHARDED[stage] = rep.seconds[stage]
    for name in rep.w2vec:
        UNSHARDED[f"knn {name}"] = rep.seconds[f"knn {name}"]
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
# phase 4c: SGNS's plain-SGD and fused-accumulator paths
# --------------------------------------------------------------------------
def phase_sgns_paths(dev, smi, sp):
    """w2v-1-2 one epoch on the split's events in four step kinds (block
    Adagrad, block SGD, fused chunk, unfused chunk): a warm-up training
    of each, then SGNS_ROUNDS more in alternating order, timed on their
    step loops alone (scripts/probe_sgns_torch.py's step_kind_times);
    fused bit-equal to chunk at this V and on a small corpus. -> {kind:
    median ms a step}."""
    from otto_tpu_torch.config import W2VEC_MODELS
    from otto_tpu_torch.data.synthetic import SyntheticSpec, generate_device
    from otto_tpu_torch.models import word2vec as w2v
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    from probe_sgns_torch import format_step_kind_times, step_kind_times

    full = sp.train.concat(sp.test)
    # chunk negatives, as at the reference's scale (neg_sharing "auto" picks
    # them from 100k words or 5M positions)
    base = dataclasses.replace(W2VEC_MODELS["w2v-1-2"], epochs=1, neg_sharing="chunk")
    t0 = time.perf_counter()
    times, models = step_kind_times(full, base, N_AIDS, dev, SGNS_ROUNDS)
    dt = time.perf_counter() - t0
    for kind, m in models.items():
        r = m.report
        print(f"# SGNS w2v-1-2 {kind}: {r.mode} steps, {r.optimizer}, V = {r.words}, "
              f"{r.steps_per_epoch} steps of {r.pairs_per_step} pairs; loss "
              f"{r.epoch_loss[0]:.4f}; finite share of the table "
              f"{float(np.isfinite(m.emb).mean()):.4f}")
    print(f"# SGNS step loops alone, a warm-up and {SGNS_ROUNDS} rounds in alternating "
          f"order ({dt:.1f} s in all; {smi}):")
    for line in format_step_kind_times(times):
        print(f"#   {line}")
    want_modes = {"block adagrad": ("block", "adagrad"), "block sgd": ("block", "sgd"),
                  "fused chunk": ("fused", "adagrad"), "chunk": ("chunk", "adagrad")}
    for kind, want in want_modes.items():
        r = models[kind].report
        require((r.mode, r.optimizer) == want, f"SGNS {kind}: {r.mode}, {r.optimizer}")
    for kind in ("block adagrad", "fused chunk"):
        require(bool(np.isfinite(models[kind].emb).all()), f"SGNS {kind}: finite table")
    require(np.array_equal(models["fused chunk"].emb, models["chunk"].emb),
            "SGNS fused chunk steps bit-equal to chunk steps at w2v-1-2's V")
    require(models["fused chunk"].report.epoch_loss == models["chunk"].report.epoch_loss,
            "SGNS fused and chunk losses equal")
    ms = {kind: statistics.median(t) for kind, t in times.items()}

    ev = generate_device(SyntheticSpec(n_sessions=20_000, n_aids=50_000, max_len=128,
                                       mean_len=14, seed=SEED + 3), dev)
    small = dataclasses.replace(base, name="x", types=(0, 1, 2), min_count=2, epochs=2,
                                neg_sharing="chunk")
    with mock.patch.dict(os.environ, OTTO_W2V_FUSED="1"):
        fused = w2v.train_word2vec_device(ev, small, 50_000, device=dev)
    with mock.patch.dict(os.environ, OTTO_W2V_FUSED="0", OTTO_W2V_BLOCK="0"):
        chunk = w2v.train_word2vec_device(ev, small, 50_000, device=dev)
    require(fused.report.mode == "fused" and chunk.report.mode == "chunk"
            and np.array_equal(fused.emb, chunk.emb),
            "SGNS fused chunk steps bit-equal to chunk steps on the small corpus")
    print(f"# SGNS fused vs chunk: bit-equal at V = {models['chunk'].report.words} (one "
          f"epoch) and V = {fused.report.words} ({fused.report.steps_per_epoch} x 2 steps); "
          f"median ms a step of the step loops: "
          f"{json.dumps({k: round(v, 3) for k, v in ms.items()})} ({smi})")
    return ms


# --------------------------------------------------------------------------
# phase 4b: training from the built tables
# --------------------------------------------------------------------------
def valid_baselines(feats, y, sess, max_group, k, cap=0, seed=0):
    """Valid ndcg@k of two label-blind orders on the valid groups the
    trainer evaluates (train_ranker_cached's 75/25 session split; `cap`
    groups drawn with `seed` as train_gbdt_ranker caps them, none for the
    MLP; grouped at max_group): all-zero scores, random scores, and the
    candidates' recency order (ts_order_aid, ties at random). All-zero
    scores rank each group in slot order, and the groups hold their
    positives first, so that ndcg is 1 by construction: it is printed, and
    the check compares with the other two."""
    from otto_tpu_torch.engine.retrieval import FEATURE_INDEX
    from otto_tpu_torch.models.gbdt import _cap_groups
    from otto_tpu_torch.models.ranker import _group_pad, ndcg_at_k

    u = np.unique(sess)
    vmask = np.isin(sess, u[max(1, int(len(u) * 0.75)):])
    vf, vy, vs = _cap_groups(feats[vmask], y[vmask], sess[vmask], cap, seed, "valid")
    fg, lg, mg = _group_pad(vf[:, [FEATURE_INDEX["ts_order_aid"]]], vy, vs, max_group)
    jitter = np.random.default_rng(SEED).random(lg.shape) * 1e-3
    return {"zero": ndcg_at_k(np.zeros(lg.shape), lg, mg, k),
            "random": ndcg_at_k(jitter, lg, mg, k),
            "recency": ndcg_at_k(-fg[..., 0].astype(np.float64) + jitter, lg, mg, k),
            "groups": lg.shape[0]}


def phase_training(dev, smi, sp, retriever, work, batch=BATCH):
    """Pass A over every test session with the split's labels, then the
    three rankers at GBDTConfig() defaults from its rows. -> (rankers,
    pass A launches, training launches, pass A metrics)."""
    from otto_tpu_torch.config import TYPES, Config, RankerConfig
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
    with batches_retrieved() as n_batches:
        metrics, rep = pass_a(retriever, sp.test, sp.labels, RankerConfig(), work,
                              batch_sessions=batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    UNSHARDED["pass A"] = dt
    pa_launches = launch_counts()
    print(f"# pass A (overlapped): {rep.sessions} sessions in {rep.batches} batches, "
          f"{dt:.2f} s = {rep.sessions / dt:.1f} sessions/s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated, "
          f"launches {pa_launches} ({smi}; PR 6's sequential runs: 18.48-26.18 s)")
    print(f"#   seconds by phase: {json.dumps({k: round(v, 3) for k, v in rep.phases.items()})}")
    # the same pass in turn on one thread: its outputs bit-equal, its time
    with tempfile.TemporaryDirectory() as seq:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m_seq, rep_seq = pass_a(retriever, sp.test, sp.labels, RankerConfig(), seq,
                                batch_sessions=batch, overlap=False)
        torch.cuda.synchronize()
        dt_seq = time.perf_counter() - t0
        print(f"# pass A (sequential): {dt_seq:.2f} s, seconds by phase: "
              f"{json.dumps({k: round(v, 3) for k, v in rep_seq.phases.items()})} ({smi})")
        require(m_seq == metrics and rep_seq.rows == rep.rows,
                "sequential pass A: the same metrics and rows")
        for name in ("eval_retrieved.json", "eval_retrieved_sources.json",
                     "passA-metrics.json"):
            with open(os.path.join(work, name)) as a, open(os.path.join(seq, name)) as b:
                require(a.read() == b.read(), f"sequential pass A: {name} equal")
        for t in TYPES:
            za = np.load(os.path.join(work, f"downsampled-{t}.npz"))
            zb = np.load(os.path.join(seq, f"downsampled-{t}.npz"))
            require(all(za[k].tobytes() == zb[k].tobytes() for k in ("feats", "y", "session")),
                    f"sequential pass A: {t} rows bit-equal")
        print("#   overlapped and sequential pass A: rows (float16 bytes), labels, "
              "sessions, reports and metrics bit-equal")
    for t in TYPES:
        print(f"#   {t}: {rep.rows[t]} rows kept, {rep.positive_sessions[t]} sessions "
              f"with a positive")
    print(f"#   ceiling recall: {json.dumps({k: metrics[k] for k in metrics if k.startswith('ceiling')})}")
    print(f"#   candidates/session: mean {metrics['cand_per_session_mean']:.1f} "
          f"min {metrics['cand_per_session_min']} max {metrics['cand_per_session_max']}")
    require(rep.sessions == n_test, "pass A covers every test session")
    require(pa_launches["gather_rows"] > 0 and pa_launches["segmented_scan"] > 0,
            f"K1 and K2 launched in pass A: {pa_launches}")
    require_k7(pa_launches, n_batches[0], "pass A")
    require_k8(pa_launches, n_batches[0], "pass A")
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

    cfg = Config().gbdt
    rankers = {}
    zero_launch_counts()
    with k1_calls("training"):
        for t in TYPES:
            feats, y, sess = load_downsampled(work, t)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r = train_ranker_cached(work, t, lambda: (feats, y, sess), Config(), dev,
                                    use_cache=False)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            base = valid_baselines(feats, y, sess, cfg.max_group, cfg.ndcg_at,
                                   cfg.max_valid_groups, cfg.seed)
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
    with k1_calls("serving") as shapes, batches_retrieved() as n_batches:
        preds = score_pass(retriever, sp.test, rankers, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    UNSHARDED["serving"] = dt
    UNSHARDED["preds"] = preds
    print(f"# K1 launches on the serving path by shape (B, S, P, W): "
          f"{sorted(shapes.items(), key=lambda kv: (-kv[1], kv[0]))}")
    require(sum(shapes.values()) == launches["gather_rows"],
            f"K1 shape histogram covers every serving launch: {shapes} vs {launches}")
    peak = torch.cuda.max_memory_allocated()
    with tempfile.TemporaryDirectory() as work:
        recall = submit_and_eval(work, preds, sp.labels)
    print(f"# main path: {n_test} sessions in {dt:.2f} s = "
          f"{n_test / dt:.1f} sessions/s, peak {peak / 2**30:.2f} GiB allocated, "
          f"launches {launches}, of them the tree walk's "
          f"{WALK['launches']['serving']} ({smi})")
    require(launches["gather_rows"] > 0 and launches["segmented_scan"] > 0,
            f"K1 and K2 launched on the serving path: {launches}")
    require(launches["gbdt_walk"] > 0 and WALK["launches"]["serving"] == 0,
            f"K5 walks the trees, K1 not: {launches}")
    require_k7(launches, n_batches[0], "serving")
    require_k8(launches, n_batches[0], "serving")
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
    return launches, recall, base


def phase_hstu(dev, smi, sp, retriever, batch=BATCH):
    """Phase 5c: the HSTU ranker (ranker_backend "hstu") at its default
    widths, weights drawn from SEED over the N_AIDS items, serves the test
    sessions through score_pass: one K6 launch a block and one K4 item
    lookup a batch, every session listed. -> launch counts."""
    from otto_tpu_torch.config import HSTUConfig, TYPES
    from otto_tpu_torch.engine.retrieval import FEATURE_NAMES
    from otto_tpu_torch.models import hstu
    from otto_tpu_torch.pipeline.runner import score_pass

    cfg = HSTUConfig()
    g = torch.Generator(device=dev).manual_seed(SEED)
    params = {}
    for name, shape in hstu.param_shapes(cfg, N_AIDS, len(FEATURE_NAMES)).items():
        std = 1.0 if name == "item_emb" else 0.5 if name.startswith(("w_pos", "w_time")) \
            else 0.1 if name.startswith(("b1", "b2", "head_b", "type")) else shape[0] ** -0.5
        params[name] = torch.randn(shape, generator=g, device=dev) * std
    params["norm_mean"] = torch.zeros(len(FEATURE_NAMES), device=dev)
    params["norm_std"] = torch.full((len(FEATURE_NAMES),), 2.0, device=dev)
    ranker = hstu.HSTURanker(cfg, params, tuple(FEATURE_NAMES))
    calls = []
    inner = ranker.predict_scores_multi
    ranker.predict_scores_multi = lambda b: calls.append(1) or inner(b)
    rankers = {t: ranker for t in TYPES}
    n_test = int(np.unique(sp.test.session).size)
    ranker.predict_scores_multi(next(retriever.iter_run(sp.test, batch_sessions=batch)))
    calls.clear()
    zero_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with batches_retrieved() as n_batches:
        preds = score_pass(retriever, sp.test, rankers, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    print(f"# HSTU serving: {n_test} sessions in {dt:.2f} s = {n_test / dt:.1f} sessions/s, "
          f"{len(calls)} batches, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"allocated, launches {launches} ({smi})")
    require(launches["hstu_attention"] == cfg.n_blocks * len(calls) > 0,
            f"one K6 launch a block a batch: {launches}, {len(calls)} batches")
    require(launches["gather_rows_hbm"] >= len(calls), f"K4 reads the items: {launches}")
    require_k7(launches, n_batches[0], "HSTU serving")
    require_k8(launches, n_batches[0], "HSTU serving")
    for t, (s_, a) in preds.items():
        require(s_.shape == (n_test,) and a.shape == (n_test, 20), f"HSTU {t} shapes")
        require((a[:, 0] >= 0).mean() > 0.99, f"HSTU {t} sessions get predictions")
    del params, ranker, rankers
    return launches


def phase_mla_moe(dev, smi, sp, retriever, batch=BATCH, n_sessions=16384):
    """Phase 5d: the MLA + MoE ranker (ranker_backend "mla_moe") at
    Moonlight-16B-A3B's widths with its first three layers, weights drawn
    from SEED over the N_AIDS items at the benchmark's scales, serves the
    first n_sessions test sessions through score_pass: one softmax K6
    launch a layer a batch, two K9 launches a MoE layer's chunk, one K4
    item lookup a batch, every session listed. -> launch counts."""
    from benchmark import serve_mla_moe
    from otto_tpu_torch.config import MLAMoEConfig, TYPES
    from otto_tpu_torch.engine.retrieval import FEATURE_NAMES
    from otto_tpu_torch.models import mla_moe
    from otto_tpu_torch.pipeline.runner import score_pass

    cfg = dataclasses.replace(MLAMoEConfig(), num_hidden_layers=3)
    params = serve_mla_moe.mla_moe_weights(dataclasses.asdict(cfg), N_AIDS,
                                           len(FEATURE_NAMES), SEED, dev)
    ranker = mla_moe.MLAMoERanker(cfg, params, tuple(FEATURE_NAMES))
    rankers = {t: ranker for t in TYPES}
    sessions = np.unique(sp.test.session)[:n_sessions]
    test = sp.test.select(np.isin(sp.test.session, sessions))
    ranker.predict_scores_multi(next(retriever.iter_run(test, batch_sessions=batch)))
    routed = [0]
    route = mla_moe.route

    def counted(*a, **kw):
        routed[0] += 1
        return route(*a, **kw)

    zero_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mla_moe.route = counted
    try:
        t0 = time.perf_counter()
        with batches_retrieved() as n_batches:
            preds = score_pass(retriever, test, rankers, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        mla_moe.route = route
    launches = launch_counts()
    print(f"# MLA + MoE serving ({cfg.num_hidden_layers} layers): {len(sessions)} sessions in "
          f"{dt:.2f} s = {len(sessions) / dt:.1f} sessions/s, {n_batches[0]} batches, "
          f"{routed[0]} routed chunks, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB allocated, launches {launches} ({smi})")
    require(launches["softmax_attention"] == cfg.num_hidden_layers * n_batches[0] > 0,
            f"one softmax K6 launch a layer a batch: {launches}, {n_batches[0]} batches")
    require_k9(launches, routed[0], "MLA + MoE serving")
    require(launches["gather_rows_hbm"] >= n_batches[0], f"K4 reads the items: {launches}")
    require_k7(launches, n_batches[0], "MLA + MoE serving")
    require_k8(launches, n_batches[0], "MLA + MoE serving")
    for t, (s_, a) in preds.items():
        require(s_.shape == (len(sessions),) and a.shape == (len(sessions), 20),
                f"MLA + MoE {t} shapes")
        require((a[:, 0] >= 0).mean() > 0.99, f"MLA + MoE {t} sessions get predictions")
    del params, ranker, rankers
    return launches


# --------------------------------------------------------------------------
# phase 5b: the MLP ranker, trained and served
# --------------------------------------------------------------------------
def phase_mlp(dev, smi, sp, retriever, work, ceiling, gbdt_recall, base_recall,
              batch=BATCH):
    """The MLP backend at RankerConfig() defaults: three towers trained
    from pass A's persisted rows into the work dir (ranker-mlp-{t}.npz
    beside the GBDT's files), each beating the label-blind orders of its
    own valid groups, then served by score_pass over every test session.
    -> (training launches, serving launches)."""
    from otto_tpu_torch.config import TYPES, Config
    from otto_tpu_torch.models import ranker as mlp
    from otto_tpu_torch.pipeline.runner import (
        load_downsampled,
        score_pass,
        submit_and_eval,
        train_ranker_cached,
    )

    cfg = Config(ranker_backend="mlp")
    rc = cfg.ranker
    n_test = int(np.unique(sp.test.session).size)
    rankers = {}
    zero_launch_counts()
    for t in TYPES:
        feats, y, sess = load_downsampled(work, t)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = train_ranker_cached(work, t, lambda: (feats, y, sess), cfg, dev, use_cache=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        base = valid_baselines(feats, y, sess, rc.max_group, rc.eval_at)
        ndcg = [h[2] for h in r.history]
        print(f"# MLP ranker {t}: {len(y)} rows, {int(np.unique(sess).size)} groups "
              f"({base['groups']} valid), {dt:.2f} s, {r.steps} steps = "
              f"{r.steps / dt:.1f} steps/s, best epoch {r.best_epoch} of {len(ndcg)} run, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated ({smi})")
        print(f"#   valid ndcg@{rc.eval_at} by epoch: {json.dumps([round(v, 5) for v in ndcg])};"
              f" all-zero {base['zero']:.5f}, random {base['random']:.5f}, recency order "
              f"{base['recency']:.5f}; loss by epoch "
              f"{json.dumps([round(h[1], 5) for h in r.history])}")
        require(os.path.exists(os.path.join(work, f"ranker-mlp-{t}.npz")),
                f"{t}: ranker-mlp-{t}.npz written")
        require([tuple(w.shape) for w in r.tower.w] == [(104, 256), (256, 128), (128, 64),
                                                          (64, 1)],
                f"{t}: the tower at RankerConfig() width")
        require(max(ndcg) > max(base["random"], base["recency"]),
                f"{t}: best valid ndcg {max(ndcg):.5f} beats the label-blind orders")
        rankers[t] = r
    tr_launches = launch_counts()
    print(f"# MLP training launches {tr_launches} ({smi})")

    # one step and one batch's scoring at full width, CUDA events
    feats, y, sess = load_downsampled(work, "clicks")
    fg, lg, mg = mlp._group_pad(feats[: 1 << 20].astype(np.float32), y[: 1 << 20],
                                sess[: 1 << 20], rc.max_group)
    step_batch = tuple(torch.from_numpy(a[: rc.batch_sessions]).to(dev) for a in (fg, lg, mg))
    tower = mlp.init_ranker(fg.shape[2], rc, *mlp.compute_norm_stats(feats[: 1 << 20])).to(dev)
    opt = mlp.make_optimizer(tower, rc)
    step_ms = cuda_ms(lambda: mlp.train_step(tower, opt, step_batch, 1e-4, rc.sigma,
                                             rc.eval_at))
    b = next(retriever.iter_run(sp.test, batch_sessions=batch))
    r = rankers["clicks"]
    score_ms = cuda_ms(lambda: r.predict_scores_device(b.feats))
    # multiply-add FLOPs of one tower over the batch's candidates
    flops = 2 * b.feats.shape[0] * b.feats.shape[1] * sum(w.numel() for w in r.tower.w)
    print(f"# MLP train step [{rc.batch_sessions}, {rc.max_group}, {fg.shape[2]}]: "
          f"{step_ms:.3f} ms; scoring one batch {tuple(b.feats.shape)} through one tower: "
          f"{score_ms:.3f} ms = {flops / (score_ms * 1e-3) / 1e12:.2f} "
          f"TFLOP/s ({smi})")
    del b, fg, lg, mg, step_batch, tower, opt

    zero_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with k1_calls("mlp serving") as shapes, batches_retrieved() as n_batches:
        preds = score_pass(retriever, sp.test, rankers, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        recall = submit_and_eval(tmp, preds, sp.labels)
    print(f"# MLP serving: {n_test} sessions in {dt:.2f} s = {n_test / dt:.1f} sessions/s, "
          f"peak {peak / 2**30:.2f} GiB allocated, launches {launches}, of them the tree "
          f"walk's {WALK['launches']['mlp serving']} ({smi})")
    print(f"#   K1 launches by shape (B, S, P, W): "
          f"{sorted(shapes.items(), key=lambda kv: (-kv[1], kv[0]))}")
    require(launches["gather_rows"] > 0 and launches["segmented_scan"] > 0,
            f"K1 and K2 launched on the MLP serving path: {launches}")
    require(WALK["launches"]["mlp serving"] == 0 and launches["gbdt_walk"] == 0,
            "no tree walk when the MLP scores")
    require_k7(launches, n_batches[0], "MLP serving")
    require_k8(launches, n_batches[0], "MLP serving")
    for t, (s_, a) in preds.items():
        require(s_.shape == (n_test,) and a.shape == (n_test, 20), f"MLP {t} shapes")
        require(((a >= -1) & (a < N_AIDS)).all(), f"MLP {t} aids in range")
        require((a[:, 0] >= 0).mean() > 0.99, f"MLP {t} sessions get predictions")
    print("# recall@20, MLP rankers / GBDT rankers / retrieval ceiling / baseline:")
    for k in ("clicks", "carts", "orders", "total"):
        print(f"#   {k}: {recall[k]:.5f} / {gbdt_recall[k]:.5f} / "
              f"{ceiling['ceiling_' + k]:.5f} / {base_recall[k]:.5f}")
    require(all(0.0 < recall[k] <= ceiling["ceiling_" + k] + 1e-12 for k in recall),
            "MLP recall@20 in (0, the retrieval ceiling]")
    return tr_launches, launches


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
# phase 7: the batch runner from the artifact cache
# --------------------------------------------------------------------------
def close(x, y, path="", tol=1e-9):
    """Two JSON reports equal: the same keys, numbers within tol."""
    if isinstance(x, dict):
        require(isinstance(y, dict) and set(x) == set(y), f"{path}: keys {set(x) ^ set(y)}")
        for k in x:
            close(x[k], y[k], f"{path}/{k}", tol)
    else:
        require(abs(x - y) <= tol, f"{path}: {x} vs {y}")


# what phase 9's batch runner on the mesh holds byte for byte to phase 7's
BATCH_OUTPUTS = ("eval_retrieved.json", "eval_retrieved_sources.json", "submission.csv")


def batch_steps(stage_log):
    """A batch runner's seconds by step from its Pipeline.stage_log (seconds
    since retrieve_with_features began: build, retrieve, eval; since
    rank_and_eval began: score, submit and eval)."""
    log = {e["stage"]: e["elapsed_s"] for e in stage_log}
    return {"build (cache load + popularity)": log["context built"],
            "retrieval": log["retrieve"] - log["context built"],
            "host C14 eval": log["eval per-source"] - log["retrieve"],
            "scoring": log["score"],
            "submit": log.get("eval", log["submit"]) - log["score"]}


def keep_batch_outputs(work, metrics, steps):
    """Copy a batch run's BATCH_OUTPUTS into work/batch-ref (the work dir's
    own are rewritten by later runs) -> what phase 9 holds its run to."""
    import shutil

    keep = os.path.join(work, "batch-ref")
    os.makedirs(keep, exist_ok=True)
    for name in BATCH_OUTPUTS:
        shutil.copyfile(os.path.join(work, name), os.path.join(keep, name))
    return {"dir": keep, "metrics": metrics, "steps": steps}


def phase_batch_runner(dev, smi, sp, retriever, work, serve_recall, batch=BATCH):
    """Pipeline.run (the batch runner) on phase 4's work dir: tables from
    the cache bit-equal to phase 4's, phase 4b's rankers, the host C14
    eval equal to pass A's device report and recall@20 equal to phase 5's.
    -> (launches, keep_batch_outputs(...))."""
    from otto_tpu_torch.config import Config, RetrievalConfig
    from otto_tpu_torch.eval.recall import evaluate_submission_file
    from otto_tpu_torch.pipeline.runner import Pipeline

    passa = {}
    for name in ("eval_retrieved.json", "eval_retrieved_sources.json"):
        with open(os.path.join(work, name)) as fh:
            passa[name] = json.load(fh)
    rankers = {f: os.stat(os.path.join(work, f)).st_mtime_ns for f in os.listdir(work)
               if f.startswith("ranker-gbdt-")}
    pipe = Pipeline(Config(retrieval=RetrievalConfig()), work, N_AIDS, device=dev)
    built = {}
    build = pipe.build_retriever
    pipe.build_retriever = lambda train, test: built.setdefault("r", build(train, test))
    zero_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with batches_retrieved() as n_batches:
        metrics = pipe.run(sp.train, sp.test, sp.labels, batch_sessions=batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    rep = pipe.build_report
    cache = rep.cache
    require(len(cache["loaded"]) == 7 and not cache["written"],
            f"every artifact read from the cache: {cache}")
    for a, b in zip(built["r"].ctx.tensors(), retriever.ctx.tensors()):
        require(a.dtype == b.dtype and torch.equal(a, b), "tables from the cache bit-equal")
    for f in ("ids", "cluster", "emb"):
        require(np.array_equal(getattr(built["r"].sessions, f), getattr(retriever.sessions, f)),
                f"session lookup {f} from the cache bit-equal")
    require(rankers == {f: os.stat(os.path.join(work, f)).st_mtime_ns for f in rankers},
            "the rankers are phase 4b's files")
    launches_ok = launches["gather_rows"] > 0 and launches["segmented_scan"] > 0
    require(launches_ok and launches["mips_topk"] == 0 and launches["gather_rows_hbm"] == 0,
            f"K1 and K2 launched, K3 and K4 not (their tables cached): {launches}")
    require_k7(launches, n_batches[0], "batch runner")
    require_k8(launches, n_batches[0], "batch runner")
    for name, want in passa.items():
        with open(os.path.join(work, name)) as fh:
            close(json.load(fh), want, name)
    for k in ("clicks", "carts", "orders", "total"):
        require(abs(metrics[k] - serve_recall[k]) <= 1e-9,
                f"batch recall@20 {k} {metrics[k]} vs streaming {serve_recall[k]}")
    res2 = evaluate_submission_file(os.path.join(work, "submission.csv"), sp.labels)
    require(all(abs(res2[k] - metrics[k]) <= 1e-9 for k in res2), "submission re-parse agrees")

    load_s = sum(v for k, v in rep.seconds.items() if k.startswith("load "))
    steps = batch_steps(pipe.stage_log)
    print(f"# batch runner: {len(np.unique(sp.test.session))} sessions in {dt:.2f} s, cache "
          f"load {load_s:.2f} s, seconds {json.dumps({k: round(v, 2) for k, v in steps.items()})}, "
          f"peak {peak / 2**30:.2f} GiB allocated, launches {launches} ({smi})")
    print("#   tables from the cache bit-equal to phase 4's; host ceiling and per-source "
          "report within 1e-9 of pass A's device report; recall@20 within 1e-9 of phase "
          f"5's streaming run: {json.dumps({k: metrics[k] for k in ('clicks', 'carts', 'orders', 'total')})}")
    UNSHARDED["batch runner"] = dt
    return launches, keep_batch_outputs(work, metrics, steps)


# --------------------------------------------------------------------------
# phase 8: the tool
# --------------------------------------------------------------------------
def write_otto_jsonl(ev_path, lab_path, ev, labels):
    """Events and labels as OTTO JSONL: a sessions line per run of equal
    session ids, a labels line per session (timestamps in seconds)."""
    names = ("clicks", "carts", "orders")
    starts = np.flatnonzero(np.r_[True, ev.session[1:] != ev.session[:-1]])
    ends = np.r_[starts[1:], len(ev)]
    aid, ts, typ = ev.aid.tolist(), ev.ts.tolist(), ev.type.tolist()
    with open(ev_path, "w") as fh:
        for a, b in zip(starts.tolist(), ends.tolist()):
            events = [{"aid": aid[i], "ts": ts[i], "type": names[typ[i]]} for i in range(a, b)]
            fh.write(json.dumps({"session": int(ev.session[a]), "events": events}) + "\n")
    rows = {}
    for s, t, a in zip(labels.session.tolist(), labels.type.tolist(), labels.aid.tolist()):
        rows.setdefault(s, {}).setdefault(names[t], []).append(a)
    with open(lab_path, "w") as fh:
        for s, by_type in rows.items():
            fh.write(json.dumps({"session": s, "labels": by_type}) + "\n")


# `python -m otto_tpu_torch.pipeline.cli ARGS`, printing the kernels' launch
# counts to stderr at exit
CLI_WITH_COUNTS = """
import atexit, json, runpy, sys
import chip_smoke
_counting = chip_smoke.batches_retrieved()   # held: its exit would unwrap
_batches = _counting.__enter__()
atexit.register(lambda: print("LAUNCHES " + json.dumps(chip_smoke.launch_counts())
                              + "\\nBATCHES " + str(_batches[0]), file=sys.stderr))
sys.argv = ["otto_tpu_torch.pipeline.cli"] + sys.argv[1:]
runpy.run_module("otto_tpu_torch.pipeline.cli", run_name="__main__", alter_sys=True)
"""


def phase_tool(smi, sp, root):
    """JSONL ingestion with the native parser, then the CLI's run-synthetic
    --tiny twice on one work dir (on the card by default), the second run
    from the cache. -> the launches of both runs."""
    from otto_tpu_torch.data import jsonl

    ev_path, lab_path = os.path.join(root, "test.jsonl"), os.path.join(root, "labels.jsonl")
    t0 = time.perf_counter()
    write_otto_jsonl(ev_path, lab_path, sp.test, sp.labels)
    t_write = time.perf_counter() - t0
    require(jsonl.parser_kind() == "native", "the native JSONL parser builds and loads")
    t0 = time.perf_counter()
    ev = jsonl.load_sessions_jsonl(ev_path)
    lab = jsonl.load_labels_jsonl(lab_path)
    t_load = time.perf_counter() - t0
    for c in ("session", "aid", "ts", "type"):
        require(np.array_equal(getattr(ev, c), getattr(sp.test, c)), f"JSONL events {c} equal")

    def rows(x):
        return sorted(zip(x.session.tolist(), x.type.tolist(), x.aid.tolist()))
    require(rows(lab) == rows(sp.labels), "JSONL labels equal")
    print(f"# JSONL: {len(ev)} events and {len(lab)} labels written in {t_write:.2f} s, "
          f"parsed by the native parser in {t_load:.2f} s, equal to the split's")

    work = os.path.join(root, "cli")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))] + [p for p in [env.get("PYTHONPATH")] if p])
    runs, total = [], {}
    for i in range(2):
        before = {f: os.stat(os.path.join(work, f)).st_mtime_ns
                  for f in (os.listdir(work) if i else [])
                  if f.endswith((".npz", ".pkl"))}
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", CLI_WITH_COUNTS, "run-synthetic", "--tiny",
                              "--work-dir", work], capture_output=True, text=True, env=env,
                             timeout=600)
        dt = time.perf_counter() - t0
        require(out.returncode == 0, f"run-synthetic --tiny run {i + 1} exit 0: "
                f"{out.stderr[-3000:]}")
        metrics = json.loads(out.stdout[out.stdout.index("{"):])
        launches = json.loads(out.stderr.rsplit("LAUNCHES ", 1)[1].splitlines()[0])
        require_k7(launches, int(out.stderr.rsplit("BATCHES ", 1)[1].split()[0]),
                   f"CLI run {i + 1}")
        require_k8(launches, int(out.stderr.rsplit("BATCHES ", 1)[1].split()[0]),
                   f"CLI run {i + 1}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        print(f"# run-synthetic --tiny (run {i + 1}): {dt:.2f} s of command, launches "
              f"{launches}, metrics {json.dumps(metrics)} ({smi})")
        require(all(0.0 < metrics[k] <= 1.0 for k in ("clicks", "carts", "orders", "total")),
                "recall@20 in (0, 1]")
        require(launches["gather_rows"] > 0 and launches["segmented_scan"] > 0,
                f"K1 and K2 launched by the CLI run: {launches}")
        if i == 0:
            require(launches["mips_topk"] > 0 and launches["gather_rows_hbm"] > 0,
                    f"K3 and K4 launched by the first CLI run: {launches}")
        else:
            after = {f: os.stat(os.path.join(work, f)).st_mtime_ns for f in before}
            require(before == after and len(before) >= 10,
                    f"the second run rewrote no artifact ({sorted(before)})")
            require(launches["mips_topk"] == 0 and launches["gather_rows_hbm"] == 0,
                    f"the second run built no kNN or session embeddings: {launches}")
            require(metrics == runs[0], f"identical metrics: {metrics} vs {runs[0]}")
        runs.append(metrics)
    print(f"#   second run from the cache ({len(before)} artifacts untouched), metrics identical")
    return total


# --------------------------------------------------------------------------
# phase 10: the reference-scale script at a small scale
# --------------------------------------------------------------------------
FULLSCALE_SESSIONS, FULLSCALE_AIDS = 30_000, 50_000
# the stages the script's record must hold, in order: its own two, then
# otto_tpu's stage names of Pipeline.run_streaming at Config()'s width
FULLSCALE_STAGES = [
    "generate", "split", "covis", "w2vec w2v-all", "w2vec w2v-1-2", "session_emb",
    "kmeans", "popularity", "context built", "retrieve+downsample (pass A)",
    "eval_retrieved", "eval per-source", "downsample clicks persisted",
    "downsample carts persisted", "downsample orders persisted", "ranker clicks (gbdt)",
    "ranker carts (gbdt)", "ranker orders (gbdt)", "score (pass B)", "submit", "eval"]
SCRIPT_WITH_COUNTS = """
import atexit, json, runpy, sys
import chip_smoke
_counting = chip_smoke.batches_retrieved()   # held: its exit would unwrap
_batches = _counting.__enter__()
atexit.register(lambda: print("LAUNCHES " + json.dumps(chip_smoke.launch_counts())
                              + "\\nBATCHES " + str(_batches[0]), file=sys.stderr))
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def phase_fullscale(smi, root):
    """scripts/run_fullscale_torch.py in a subprocess on the card at
    FULLSCALE_SESSIONS sessions and FULLSCALE_AIDS aids (Config()'s full
    width), in a work dir of its own: exit 0, a complete record (every
    stage of FULLSCALE_STAGES with its seconds, host RSS and peak device
    memory; the card's name; metrics and the per-source report), every
    kernel launched, and ranked recall@20 above the heuristic baseline's
    on the same test sessions and co-visitation tables. -> its launches."""
    from otto_tpu_torch.config import COVIS_FIRST_N, DEFAULT, TYPES
    from otto_tpu_torch.data.schema import Events
    from otto_tpu_torch.data.split import split_events
    from otto_tpu_torch.engine import baseline
    from otto_tpu_torch.engine.covis import CoVisTables
    from otto_tpu_torch.eval.recall import evaluate_topk

    here = os.path.dirname(os.path.abspath(__file__))
    work, out_path = os.path.join(root, "fullscale"), os.path.join(root, "fullscale.json")
    shm = "/dev/shm" if os.access("/dev/shm", os.W_OK) else root
    with tempfile.TemporaryDirectory(dir=shm) as tmpfs:
        env = dict(os.environ, OTTO_FS_SESSIONS=str(FULLSCALE_SESSIONS),
                   OTTO_FS_AIDS=str(FULLSCALE_AIDS), OTTO_FS_WORKDIR=work,
                   OTTO_FS_OUT=out_path, OTTO_FS_TMPFS=tmpfs)
        env["PYTHONPATH"] = os.pathsep.join([here] + [p for p in [env.get("PYTHONPATH")] if p])
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", SCRIPT_WITH_COUNTS,
                              os.path.join(here, "scripts", "run_fullscale_torch.py")],
                             capture_output=True, text=True, env=env, timeout=600)
        dt = time.perf_counter() - t0
        require(out.returncode == 0, f"run_fullscale_torch.py exit 0: {out.stderr[-3000:]}")
        placed = sorted(os.listdir(tmpfs))
        linked = sorted(f for f in os.listdir(work)
                        if os.path.islink(os.path.join(work, f))
                        and os.path.dirname(os.readlink(os.path.join(work, f))) == tmpfs)
        tmpfs_bytes = sum(os.path.getsize(os.path.join(tmpfs, f)) for f in placed)
        with open(out_path) as fh:
            rec = json.load(fh)
        z = np.load(os.path.join(work, "events.npz"))
        ev = {k: z[k] for k in ("session", "aid", "ts", "type")}
        with open(os.path.join(work, "covis.pkl"), "rb") as fh:
            stored = pickle.load(fh)
    want = sorted(["events.npz", "covis.pkl", "w2v-w2v-all.npz", "w2v-w2v-1-2.npz",
                   "knn-w2v-all.npz", "knn-w2v-1-2.npz", "session_emb.npz", "clusters.npz"])
    require(placed == want and linked == want,
            f"OTTO_FS_TMPFS: events and tables in {tmpfs} ({placed}), linked ({linked})")
    last = rec["stages"][-1]
    require(all({"disk_bytes", "tmpfs_bytes", "write_bytes"} <= set(e) for e in rec["stages"])
            and last["tmpfs_bytes"] == tmpfs_bytes and last["disk_bytes"] > 0,
            f"every stage's byte columns, the last one's tmpfs bytes {tmpfs_bytes}: {last}")
    launches = json.loads(out.stderr.rsplit("LAUNCHES ", 1)[1].splitlines()[0])
    require_k7(launches, int(out.stderr.rsplit("BATCHES ", 1)[1].split()[0]),
               "the reference-scale script")
    require_k8(launches, int(out.stderr.rsplit("BATCHES ", 1)[1].split()[0]),
               "the reference-scale script")
    stages = rec["stages"]
    require([e["stage"] for e in stages] == FULLSCALE_STAGES,
            f"the record's stages: {[e['stage'] for e in stages]}")
    require(all(e["delta_s"] >= 0 and e["rss_gb"] > 0 and e["peak_mem_gb"] > 0
                for e in stages[2:]), "every stage's seconds, RSS and peak memory")
    require(rec["device"]["name"] == torch.cuda.get_device_name(0)
            and rec["device"]["nvidia_smi"], f"the record's device: {rec['device']}")
    require(rec["generator"] == "device" and rec["spec"]["n_sessions"] == FULLSCALE_SESSIONS,
            "the events were drawn on the card at the asked scale")
    require("src_any" in rec["per_source"], "the per-source report is in the record")
    # the script serves GBDT rankers: K1-K5, K7 and K8 launch, K6 and K9
    # (the HSTU and MLA + MoE rankers') do not
    sequence = ("hstu_attention", "grouped_gemm", "softmax_attention")
    require(all(v > 0 for k, v in launches.items() if k not in sequence)
            and all(launches[k] == 0 for k in sequence),
            f"K1-K5, K7 and K8 launched by the script, K6 and K9 not: {launches}")
    m = rec["metrics"]

    # the heuristic baseline on the same test sessions and co-visitation tables
    sp = split_events(Events(ev["session"], ev["aid"], ev["ts"], ev["type"]),
                      DEFAULT.data.test_days, DEFAULT.data.seed)
    tables = {n: CoVisTables(*(torch.from_numpy(a).cuda() for a in stored[n]))
              for n in COVIS_FIRST_N}
    sessions, aids = baseline.recommend(sp.test, tables)
    base = evaluate_topk({t: (sessions, aids) for t in TYPES}, sp.labels)
    require(len(sessions) == rec["n_test_sessions"], "the baseline's test sessions")
    print(f"# run_fullscale_torch.py at {FULLSCALE_SESSIONS} sessions, {FULLSCALE_AIDS} aids: "
          f"{dt:.2f} s of command ({rec['pipeline_s']:.2f} s pipeline), "
          f"{rec['n_events']} events, {rec['n_test_sessions']} test sessions, launches "
          f"{launches}; stage seconds "
          f"{json.dumps({e['stage']: e['delta_s'] for e in stages[2:]})}; peak device GiB "
          f"{max(e['peak_mem_gb'] for e in stages[2:])}; recall@20 total {m['total']:.5f}, "
          f"ceiling {m['ceiling_total']:.5f}, baseline {base['total']:.5f}; "
          f"OTTO_FS_TMPFS: {tmpfs_bytes} bytes of events and tables in tmpfs, "
          f"{last['disk_bytes']} on disk, {last['write_bytes']} written ({smi})")
    require(0.0 < m["total"] <= m["ceiling_total"] <= 1.0, "recall@20 under the ceiling")
    require(m["total"] > base["total"], f"ranked recall@20 {m['total']} above the "
            f"baseline's {base['total']}")
    return launches


# --------------------------------------------------------------------------
# phase 9: the multi-device paths
# --------------------------------------------------------------------------
# phase 9's settings: w2v-1-2 in chunk steps with the per-pair sampler (what
# model-parallel training runs), one epoch; the first GBDT_TREES trees of
# phase 4b's clicks ranker (a tree depends only on the ones before it)
MESH_SGNS_EPOCHS = 1
MESH_GBDT_TREES = 25
MESH_GBDT_TARGET = "clicks"


def digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a.cpu().numpy() if torch.is_tensor(a) else a)
        h.update(str(a.dtype).encode() + str(a.shape).encode() + a.tobytes())
    return h.hexdigest()


def check_collectives(mesh, dev):
    """Every collective the sharded paths call, on this rank's device
    tensors, against what it must give."""
    import torch.distributed as dist

    n, r = mesh.n_data, mesh.data_rank
    g = mesh.data_group
    x = torch.tensor([r + 1, -(r + 1)], dtype=torch.int64, device=dev)
    dist.all_reduce(x, group=g)
    s = n * (n + 1) // 2
    require(x.tolist() == [s, -s], "all_reduce SUM (int64)")
    y = torch.tensor([float(r)], device=dev)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=g)
    require(y.item() == n - 1, "all_reduce MAX (float32)")
    z = torch.full((3,), r, dtype=torch.uint8, device=dev)
    require(mesh.gather_data(z).tolist() == [i for i in range(n) for _ in range(3)],
            "all_gather (uint8)")
    b = torch.tensor([7 + r], dtype=torch.int32, device=dev)
    dist.broadcast(b, src=dist.get_global_rank(g, 0), group=g)
    require(b.item() == 7, "broadcast (int32)")
    send = torch.arange(n, dtype=torch.int32, device=dev) + 10 * r
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=g)
    require(recv.tolist() == [10 * i + r for i in range(n)], "all_to_all_single (int32)")


def mesh_rank(rank, work, tag, world, device="cuda"):
    """One rank of phase 9: every sharded stage on phase 4's events, each
    held to phase 4 / 4b / 5's outputs on the same inputs, and its seconds,
    K1-K4 launches and peak memory written to mesh-{tag}-rank{rank}.pkl."""
    import pickle

    import torch.distributed as dist

    from otto_tpu_torch.config import (
        TYPES,
        W2VEC_MODELS,
        CoVisConfig,
        Config,
        KMeansConfig,
        PopularityConfig,
        RankerConfig,
        config_from_json,
    )
    from otto_tpu_torch.data.batching import pack_sessions
    from otto_tpu_torch.device import pin_fp32
    from otto_tpu_torch.engine.covis import ShardedCoVisCounter
    from otto_tpu_torch.engine.popularity import compute_popularity
    from otto_tpu_torch.engine.session_embed import (
        build_knn_tables,
        compute_session_embeddings,
    )
    from otto_tpu_torch.eval.recall import evaluate_topk
    from otto_tpu_torch.models.gbdt import GBDTRanker, train_gbdt_ranker
    from otto_tpu_torch.models.word2vec import Word2Vec, train_word2vec_device
    from otto_tpu_torch.ops.kmeans import kmeans_fit_dp
    from otto_tpu_torch.parallel.mesh import make_mesh
    from otto_tpu_torch.pipeline.runner import (
        FEATURE_NAMES,
        Pipeline,
        _event_clusters,
        build_retriever,
        load_downsampled,
        load_rankers,
        pass_a,
        score_pass,
    )

    pin_fp32()
    dev = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
           else torch.device(device))
    with open(os.path.join(work, "mesh-in.pkl"), "rb") as fh:
        inp = pickle.load(fh)
    sp = inp["split"]
    full = sp.train.concat(sp.test)
    out = {"seconds": {}, "launches": {}, "batches": {}, "peak": {}, "digest": {}}
    mesh = make_mesh(world, 1, device=dev)
    check_collectives(mesh, dev)

    def stage(name, fn):
        dist.barrier()
        zero_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with batches_retrieved() as n_batches:
            res = fn()
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        out["launches"][name] = launch_counts()
        out["batches"][name] = n_batches[0]
        out["peak"][name] = torch.cuda.max_memory_allocated()
        return res

    # C7: the sharded counter -> phase 4's covis.pkl, bit for bit
    def covis():
        counter = ShardedCoVisCounter(CoVisConfig(), mesh)
        try:
            counter.update(sp.train)
            counter.update(sp.test)
            return counter.retrieval_tables(N_AIDS)
        finally:
            counter.close()

    tables = stage("covis", covis)
    with open(os.path.join(work, "covis.pkl"), "rb") as fh:
        stored = pickle.load(fh)
    for name, t in tables.items():
        for f, a, b in zip(t._fields, t, stored[name]):
            require(np.array_equal(a.cpu().numpy(), b), f"sharded covis {name}.{f} bit-equal")
    del tables, stored

    # C9 / C10: kNN tables (K3) and session embeddings (K4) from the cached models
    names = list(W2VEC_MODELS)
    models = {n: Word2Vec.load(os.path.join(work, f"w2v-{n}.npz"), W2VEC_MODELS[n])
              for n in names}
    for n in names:
        kt = stage(f"knn {n}", lambda n=n: build_knn_tables(models[n], N_AIDS, dev,
                                                            mesh_ctx=mesh))
        z = np.load(os.path.join(work, f"knn-{n}.npz"))
        require(np.array_equal(kt.neighbor.cpu().numpy(), z["neighbor"]),
                f"sharded kNN {n}: neighbours bit-equal")
        require(np.array_equal(kt.dist.cpu().numpy(), z["dist"]),
                f"sharded kNN {n}: distances bit-equal")
        del kt
    aid_emb = torch.from_numpy(models[names[0]].embedding_by_aid(N_AIDS)).to(dev)
    sess_ids, sess_emb = stage("session_emb", lambda: compute_session_embeddings(
        pack_sessions(full), aid_emb, mesh_ctx=mesh))
    z = np.load(os.path.join(work, "session_emb.npz"))
    require(np.array_equal(sess_ids, z["session"]), "sharded session ids equal")
    require(np.array_equal(sess_emb.cpu().numpy(), z["emb"]),
            "sharded session embeddings bit-equal")

    # C11: dp k-means, seeded as kmeans_fit seeds
    km = KMeansConfig()
    _, labels, _, n_iter = stage("kmeans", lambda: kmeans_fit_dp(
        sess_emb, km.n_clusters_to_find[0], mesh, km.max_iter, km.tol, km.seed))
    stored_labels = np.load(os.path.join(work, "clusters.npz"))["cluster"]
    require(np.array_equal(labels.cpu().numpy(), stored_labels),
            "dp k-means labels bit-equal to phase 4's")
    out["kmeans_iter"] = n_iter
    del sess_emb

    # C12: sharded popularity from phase 4's clusters -> phase 4's tables
    ev_cl = _event_clusters(full.session, z["session"], stored_labels)
    pops = stage("popularity", lambda: (
        compute_popularity(full, ev_cl, N_CLUSTERS, N_AIDS, PopularityConfig(), dev,
                           mesh_ctx=mesh),
        compute_popularity(full, np.zeros(len(full), np.int32), 1, N_AIDS,
                           PopularityConfig(), dev, mesh_ctx=mesh)))
    for got, want, tag_ in ((pops[0].candidate, inp["pop"][0], "cl50 candidates"),
                            (pops[0].ranks, inp["pop"][1], "cl50 ranks"),
                            (pops[1].aid_rank, inp["pop"][2], "cl1 ranks")):
        require(np.array_equal(got.cpu().numpy(), want), f"sharded popularity {tag_} bit-equal")
    del pops

    # C8: w2v-1-2 model-parallel (the model axis over every rank) in chunk steps
    name = names[1]
    wcfg = dataclasses.replace(W2VEC_MODELS[name], neg_sharing="chunk", block_k=0,
                               epochs=MESH_SGNS_EPOCHS)
    mp = make_mesh(1, world, device=dev)
    model = stage(f"sgns {name}", lambda: train_word2vec_device(
        full, wcfg, N_AIDS, device=dev, mesh_ctx=mp))
    require(model.report.mode == "chunk" and np.isfinite(model.emb).all(),
            f"model-parallel {name}: chunk steps, finite")
    out["digest"]["sgns"] = digest(model.emb)
    out["sgns_steps"] = model.report.steps_per_epoch
    del model

    # C16: dp GBDT for one target from 4b's rows, 4b's split and draws
    cfg = dataclasses.replace(Config().gbdt, n_trees=MESH_GBDT_TREES)
    feats, y, sess = load_downsampled(work, MESH_GBDT_TARGET)
    u = np.unique(sess)
    vmask = np.isin(sess, u[max(1, int(len(u) * 0.75)):])
    valid = (feats[vmask], y[vmask], sess[vmask])
    feats, y, sess = feats[~vmask], y[~vmask], sess[~vmask]
    # its default draws are one device's (gbdt.one_device_draws)
    ranker = stage("gbdt", lambda: train_gbdt_ranker(
        feats, y, sess, FEATURE_NAMES, cfg, valid=valid, device=dev, mesh_ctx=mesh))
    ref = GBDTRanker.load(os.path.join(work, f"ranker-gbdt-{MESH_GBDT_TARGET}.npz"))
    for f in ("gfeat", "thr", "leaf", "gains"):
        require(np.array_equal(getattr(ranker, f), getattr(ref, f)[:MESH_GBDT_TREES]),
                f"dp GBDT {MESH_GBDT_TARGET}: {f} of the first {MESH_GBDT_TREES} trees "
                "bit-equal to phase 4b's")
    out["gbdt_evals"] = ranker.eval_history

    # serving: data-sharded retrieval (K1, K2) and scoring with 4b's rankers
    retriever, _ = build_retriever(sp.train, sp.test, N_AIDS, dev, cache_dir=work,
                                   mesh=mesh)
    rankers = load_rankers(work)
    preds = stage("serving", lambda: score_pass(retriever, sp.test, rankers, BATCH))
    for t, (s, a) in preds.items():
        s0, a0 = inp["preds"][t]
        require(np.array_equal(s, s0) and np.array_equal(a, a0),
                f"sharded serving {t}: sessions and top-20 bit-equal to phase 5's")
    recall = evaluate_topk(preds, sp.labels)
    require(recall == inp["recall"], f"sharded serving recall@20 equal: {recall}")
    out["recall_total"] = recall["total"]

    # pass A over the sharded retriever (each rank's batches, each drawn
    # from where its draws begin in one device's rng stream, on two ranks
    # the draw counts shared a round of batches; the eval counters
    # all-reduced, the rows gathered) -> phase 4b's metrics, reports and
    # rows, bit for bit
    pa_dir = os.path.join(work, f"mesh-{tag}-passA")
    os.makedirs(pa_dir, exist_ok=True)
    metrics, rep = stage("pass A", lambda: pass_a(retriever, sp.test, sp.labels,
                                                  RankerConfig(), pa_dir, batch_sessions=BATCH))
    out["passA_phases"] = rep.phases
    with open(os.path.join(work, "passA-metrics.json")) as fh:
        require(metrics == json.load(fh), "sharded pass A: metrics equal to phase 4b's")
    del retriever
    dist.barrier()   # rank 0's files are written
    # phase 7 rewrote the work dir's reports from its host eval (within
    # 1e-9 of pass A's device report); (a) and (b) are held equal byte for
    # byte in phase_multi_device
    for name in ("eval_retrieved.json", "eval_retrieved_sources.json"):
        with open(os.path.join(work, name)) as fa, open(os.path.join(pa_dir, name)) as fb:
            close(json.load(fa), json.load(fb), f"sharded pass A {name}")
    for t in TYPES:
        za = np.load(os.path.join(work, f"downsampled-{t}.npz"))
        zb = np.load(os.path.join(pa_dir, f"downsampled-{t}.npz"))
        require(all(za[k].tobytes() == zb[k].tobytes() for k in ("feats", "y", "session")),
                f"sharded pass A {t}: rows bit-equal to phase 4b's")

    # the batch runner on the mesh (Pipeline(mesh=).run: each rank keeps its
    # own batches, C14 over every rank's in one device's order, the top-20s
    # gathered) from a work dir holding phase 4's tables and phase 4b's GBDT
    # rankers -> phase 7's C14 reports, submission and metrics
    bdir = os.path.join(work, f"mesh-{tag}-batch")
    if mesh.is_main:
        seed_work_dir(work, bdir)
    dist.barrier()
    pipe = Pipeline(config_from_json(os.path.join(bdir, "config.json")), bdir, N_AIDS,
                    device=dev, mesh=mesh)
    batch_ref = inp["batch_ref"]
    metrics = stage("batch runner", lambda: pipe.run(sp.train, sp.test, sp.labels,
                                                     batch_sessions=BATCH))
    dist.barrier()   # rank 0's files are written
    for name in BATCH_OUTPUTS:
        with open(os.path.join(bdir, name), "rb") as fa, \
                open(os.path.join(batch_ref["dir"], name), "rb") as fb:
            require(fa.read() == fb.read(),
                    f"batch runner on the mesh: {name} byte-equal to phase 7's")
    require(metrics == batch_ref["metrics"], "batch runner on the mesh: metrics (ceilings, "
            f"recall@20) equal to phase 7's: {metrics} vs {batch_ref['metrics']}")
    out["batch_steps"] = batch_steps(pipe.stage_log)
    with open(os.path.join(work, f"mesh-{tag}-rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


def seed_work_dir(src, dst):
    """A work dir at dst holding src's table artifacts and GBDT rankers
    (hard links where the file system allows, else copies: the runner
    only reads them), so a Pipeline there reads every table and ranker
    from the cache."""
    import shutil

    os.makedirs(dst, exist_ok=True)
    for name in os.listdir(src):
        if name in ("covis.pkl", "session_emb.npz", "clusters.npz", "config.json",
                    "meta.json") or (name.endswith(".npz") and name.startswith(
                        ("w2v-", "knn-", "ranker-gbdt-"))):
            try:
                os.link(os.path.join(src, name), os.path.join(dst, name))
            except OSError:
                shutil.copyfile(os.path.join(src, name), os.path.join(dst, name))


def phase_multi_device(smi, sp, work, pop, preds, recall, unsharded, batch_ref,
                       device="cuda"):
    """Phase 9: the sharded paths on the card, (a) one rank over NCCL, (b)
    two ranks sharing the card over gloo, each stage held to the unsharded
    phases' outputs on the same inputs (batch_ref: phase 7's batch run,
    keep_batch_outputs; device "cpu": a rehearsal, gloo for both). -> K1-K4
    launches, summed over the stages and ranks."""
    import pickle

    from otto_tpu_torch.config import W2VEC_MODELS
    from otto_tpu_torch.parallel.distributed import spawn_ranks

    with open(os.path.join(work, "mesh-in.pkl"), "wb") as fh:
        pickle.dump({"split": sp, "pop": pop, "preds": preds, "recall": recall,
                     "batch_ref": batch_ref}, fh)
    runs = {}
    for tag, world, backend in (("a", 1, "nccl" if device == "cuda" else "gloo"),
                                ("b", 2, "gloo")):
        t0 = time.perf_counter()
        spawn_ranks(mesh_rank, world, args=(work, tag, world, device), device=device,
                    backend=backend, store_path=os.path.join(work, f"mesh-{tag}.store"))
        runs[tag] = []
        for r in range(world):
            with open(os.path.join(work, f"mesh-{tag}-rank{r}.pkl"), "rb") as fh:
                runs[tag].append(pickle.load(fh))
        print(f"# multi-device ({tag}) {world} rank(s) over {backend}: "
              f"{time.perf_counter() - t0:.1f} s with start-up; every stage held to the "
              f"unsharded phases")
    a, b = runs["a"][0], runs["b"]
    for name in ("eval_retrieved.json", "eval_retrieved_sources.json", "passA-metrics.json"):
        with open(os.path.join(work, "mesh-a-passA", name)) as fa, \
                open(os.path.join(work, "mesh-b-passA", name)) as fb:
            require(fa.read() == fb.read(), f"sharded pass A: {name} of (b) equal to (a)'s")
    for r in b:
        require(r["digest"]["sgns"] == a["digest"]["sgns"],
                "model-parallel SGNS on two ranks bit-equal to one rank")
        require(r["gbdt_evals"] == a["gbdt_evals"], "dp GBDT valid ndcg equal")
    print(f"# multi-device k-means: labels bit-equal to phase 4's on one rank and on two "
          f"({a['kmeans_iter']} and {b[0]['kmeans_iter']} iterations)")
    print(f"# multi-device SGNS {list(W2VEC_MODELS)[1]}: {a['sgns_steps']} chunk steps an "
          f"epoch, model-parallel on two ranks bit-equal to one rank")
    print(f"# multi-device seconds by stage, unsharded / (a) NCCL, 1 rank / (b) gloo, "
          f"2 ranks sharing the card (rank 0, rank 1) ({smi}); (b) shares one card, so "
          f"its times are no scaling figure:")
    for st in a["seconds"]:
        u = unsharded.get(st)
        print(f"#   {st}: {'-' if u is None else f'{u:.2f}'} / {a['seconds'][st]:.2f} / "
              f"{b[0]['seconds'][st]:.2f}, {b[1]['seconds'][st]:.2f}")
    print(f"# multi-device pass A seconds by phase, (a) / (b) rank 0 / (b) rank 1 ({smi}):")
    for ph in a["passA_phases"]:
        print(f"#   {ph}: {a['passA_phases'][ph]:.3f} / {b[0]['passA_phases'][ph]:.3f} / "
              f"{b[1]['passA_phases'][ph]:.3f}")
    print("# multi-device launches of K1 K2 K3 K4 and peak GiB allocated by stage, "
          "(a) rank 0 / (b) rank 0; rank 1:")

    def cell(run, st):
        ln = run["launches"][st]
        return (" ".join(str(ln[k]) for k in ("gather_rows", "segmented_scan", "mips_topk",
                                              "gather_rows_hbm"))
                + f", {run['peak'][st] / 2**30:.2f}")

    for st in a["launches"]:
        print(f"#   {st}: {cell(a, st)} / {cell(b[0], st)}; {cell(b[1], st)}")
    print(f"# multi-device batch runner (Pipeline(mesh=).run), seconds by step, phase 7 / "
          f"(a) / (b) rank 0, rank 1 ({smi}); C14 reports, submission and metrics equal to "
          f"phase 7's on (a) and (b):")
    for k, v in batch_ref["steps"].items():
        print(f"#   {k}: {v:.2f} / {a['batch_steps'][k]:.2f} / {b[0]['batch_steps'][k]:.2f}, "
              f"{b[1]['batch_steps'][k]:.2f}")
    print(f"#   peak GiB allocated a rank: (a) {a['peak']['batch runner'] / 2**30:.2f}, (b) "
          f"{b[0]['peak']['batch runner'] / 2**30:.2f} and "
          f"{b[1]['peak']['batch runner'] / 2**30:.2f}")
    for run in [a] + b if device == "cuda" else []:
        ln = run["launches"]
        require(ln["pass A"]["gather_rows"] > 0 and ln["pass A"]["segmented_scan"] > 0,
                "K1 and K2 launched in pass A")
        require(all(ln[f"knn {n}"]["mips_topk"] > 0 for n in W2VEC_MODELS), "K3 launched in kNN")
        require(ln["session_emb"]["gather_rows_hbm"] > 0, "K4 launched in session embeddings")
        require(ln["serving"]["gather_rows"] > 0 and ln["serving"]["segmented_scan"] > 0,
                "K1 and K2 launched in serving")
        require(ln["gbdt"]["gather_rows"] > 0, "K1 launched in dp GBDT")
        require(ln["batch runner"]["gather_rows"] > 0 and ln["batch runner"]["segmented_scan"] > 0,
                "K1 and K2 launched in the batch runner on the mesh")
        for st in ("pass A", "serving", "batch runner"):
            require_k7(ln[st], run["batches"][st], f"{st} on the mesh")
            require_k8(ln[st], run["batches"][st], f"{st} on the mesh")
    return {k: sum(run["launches"][st][k] for run in [a] + b for st in run["launches"])
            for k in a["launches"]["serving"]}


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
# the MLP tower, card against CPU: scores within about two bfloat16 ulps
# (the forward is summed in float64, so the devices agree to the bit but
# where a float32 ulp of the loss's exp / log1p meets a bfloat16 rounding
# boundary); weights after three AdamW steps from the same start
MLP_SCORE_RTOL = 2.0 ** -6
MLP_SCORE_ATOL = 1e-3
MLP_STEP_ATOL = 1e-4
SGNS_RTOL = 1e-5
SGNS_ATOL = 1e-6


def f16_ulp(x):
    """The spacing of float16 values at |x| (2^-24 below the normal range)."""
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0**-14)))
    return torch.exp2(e - 10)


def precision_flags():
    """The float32 matmul settings in force, for a failure message."""
    out = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
           "float32_matmul_precision": torch.get_float32_matmul_precision()}
    for name, mod in (("cuda.matmul", torch.backends.cuda.matmul),
                      ("mkldnn.matmul", getattr(torch.backends, "mkldnn", None) and
                       getattr(torch.backends.mkldnn, "matmul", None)),
                      ("backends", torch.backends)):
        if mod is not None and hasattr(mod, "fp32_precision"):
            out[f"{name}.fp32_precision"] = str(mod.fp32_precision)
    return out


def checksum(t):
    """(sha256 prefix of the bytes, float64 sum) of a tensor."""
    a = t.detach().cpu().contiguous().numpy()
    return hashlib.sha256(a.tobytes()).hexdigest()[:16], float(a.astype(np.float64).sum())


def embedding_parts(s, cand_row, semb_row, emb_cpu, emb_dev, dev):
    """The similarity terms of one session row recomputed on the CPU and on
    the card, in float32 and in float64: the einsum "sd,scd->sc" and the
    norms, and eucl_dist_ses_aid from them. -> {device / dtype: [C] eucl,
    dot}."""
    out = {}
    c = torch.from_numpy(np.ascontiguousarray(cand_row)).clamp(min=0).long()
    for name, emb, device in (("cpu", emb_cpu, "cpu"), ("card", emb_dev, dev)):
        for dtype in (torch.float32, torch.float64):
            e = torch.from_numpy(np.ascontiguousarray(semb_row)).to(device, dtype)[None]
            v = emb.to(dtype)[c.to(device)][None]
            dot = torch.einsum("sd,scd->sc", e, v)[0]
            ns, nc = torch.linalg.norm(e, dim=1), torch.linalg.norm(v, dim=2)[0]
            eucl = torch.sqrt(torch.clamp(ns**2 + nc**2 - 2 * dot, min=0.0))
            out[f"{name} {str(dtype)[6:]}"] = (eucl.cpu().double(), dot.cpu().double())
    return out


def cpu_similarity_errors(c_cpu, semb, aid_emb, rows):
    """The CPU's similarity block over the whole batch, as retrieve_batch
    computes it ([S, C, D] gather, einsum, norms), against float64 on
    `rows`: the largest relative error of the candidate norms, of the
    session norms and of the dot products, with this process's threads and
    with one thread. -> {threads: (norm_c, norm_s, dot)}."""
    gc = c_cpu.clamp(min=0).long()
    e32 = torch.from_numpy(np.ascontiguousarray(semb[:c_cpu.shape[0]]))
    out = {}
    for threads in (torch.get_num_threads(), 1):
        old = torch.get_num_threads()
        torch.set_num_threads(threads)
        try:
            got = []
            for dtype in (torch.float32, torch.float64):
                v = aid_emb.to(dtype)[gc]
                e = e32.to(dtype)
                got.append((torch.linalg.norm(v, dim=2), torch.linalg.norm(e, dim=1),
                            torch.einsum("sd,scd->sc", e, v)))
        finally:
            torch.set_num_threads(old)
        (nc, ns, dot), (nc64, ns64, dot64) = got
        valid = (c_cpu[rows] >= 0) & (nc64[rows] > 1e-9)

        def rel(a, b):
            return float(((a.double() - b).abs() / b.abs().clamp(min=1e-6)).max())
        out[threads] = (rel(nc[rows][valid], nc64[rows][valid]), rel(ns[rows], ns64[rows]),
                        float((dot[rows].double() - dot64[rows]).abs()[valid].max()))
    return out


def cross_check_retrieval(dev, seed, quiet=False):
    """One 256-session retrieval batch on tables seeded with `seed`, on the
    CPU, on the card and on the CPU again: the card's candidates, ts_order
    and integer features bit-equal to the second CPU run's, float features
    within FLOAT_TOL. A float feature out of tolerance fails with the
    precision flags in force, the checksums of both devices' item and
    session embeddings, and, for the first failing session row, its
    similarity terms recomputed on each device in float32 and float64 (the
    float64 row says which device is off; the checksums whether the inputs
    differed). A first CPU run that differs from the second (fault 1) is
    printed with the same evidence. -> (sessions, ctx_cpu, events, card
    outputs (cand, feats, ts_order) on the CPU, that evidence or None)."""
    from otto_tpu_torch.config import RetrievalConfig
    from otto_tpu_torch.data.batching import pack_sessions
    from otto_tpu_torch.data.synthetic import SyntheticSpec, generate_device
    from otto_tpu_torch.engine.retrieval import FEATURE_INDEX, FEATURE_NAMES, retrieve_batch

    cpu = torch.device("cpu")
    n_aids, S = 1 << 16, 256
    ev = generate_device(SyntheticSpec(n_sessions=2000, n_aids=n_aids, max_len=32,
                                       mean_len=14, seed=seed), dev)
    p = pack_sessions(ev, (32,))[0]
    cfg = RetrievalConfig()
    ctx_cpu = seeded_context(n_aids, cpu, seed)
    ctx_dev = ctx_cpu.to(dev)
    lookup = session_lookup(ev, seed)
    cluster, semb = lookup.lookup(p.session[:S])
    trim = [cfg.trim_max_at_order_1, cfg.trim_min,
            (cfg.trim_max_at_order_1 - cfg.trim_min) / (cfg.trim_min_at_order - 1)]
    inputs = {}

    def run(ctx, device):
        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x[:S])).to(device)

        inputs[str(device)] = put(semb)
        out = retrieve_batch(
            (put(p.aid), put(p.ts), put(p.type)), ctx, put(cluster), inputs[str(device)],
            torch.tensor(trim, dtype=torch.float32, device=device),
            cfg.max_session_aids, cfg.max_candidates,
        )
        return [o.cpu() for o in out]

    def describe(name, j, a, b, bad, other):
        """The evidence on entries `bad` where a (the CPU) and b (`other`)
        disagree on feature j."""
        s = int(bad.nonzero()[0, 0])
        cols = bad[s].nonzero()[:, 0][:4]
        terms = embedding_parts(s, c_cpu[s].numpy(), semb[s], ctx_cpu.aid_emb,
                                ctx_dev.aid_emb, dev)
        rows = {k: [(round(float(e[c]), 6), round(float(d[c]), 6)) for c in cols]
                for k, (e, d) in terms.items()}
        bad_rows = bad.any(1).nonzero()[:, 0]
        # the same CPU batch once more, and its similarity block recomputed
        # at full size
        f_again = run(ctx_cpu, "cpu")[1][..., j]
        again = int((~torch.isclose(f_again, b, rtol=FLOAT_TOL, atol=FLOAT_TOL)).sum())
        sims = cpu_similarity_errors(c_cpu, semb, ctx_cpu.aid_emb, bad_rows)
        return (f"{name}: {int(bad.sum())} entries off in {len(bad_rows)} session rows "
                f"{bad_rows.tolist()[:64]}; the CPU batch run again: {again} entries off "
                f"from the {other}; on those rows the CPU's full-size similarity block "
                f"against float64, max relative error of (candidate norms, session norms, "
                f"dots) by CPU threads: {sims}; session row {s}, slots {cols.tolist()}: CPU "
                f"{[round(float(a[s, c]), 6) for c in cols]}, {other} "
                f"{[round(float(b[s, c]), 6) for c in cols]}; recomputed (eucl, dot) {rows}; "
                f"precision flags {precision_flags()}; checksums (sha256, sum) aid_emb CPU "
                f"{checksum(ctx_cpu.aid_emb)} card {checksum(ctx_dev.aid_emb)}, session "
                f"embeddings CPU {checksum(inputs['cpu'])} card {checksum(inputs[str(dev)])}")

    first, (c_dev, f_dev, t_dev) = run(ctx_cpu, "cpu"), run(ctx_dev, dev)
    # fault 1 (ROADMAP Queue 3): after a long CUDA history, the CPU's first
    # run of this batch has come out wrong in the calling thread's share of
    # the session rows, while float64, a second CPU run and the card agree.
    # The card is held to a second CPU run; a first run that differs from
    # it is reported with the evidence, and returned.
    c_cpu, f_cpu, t_cpu = run(ctx_cpu, "cpu")
    first_run = None
    require(torch.equal(first[0], c_cpu) and torch.equal(first[2], t_cpu),
            "cross-check: two CPU runs give the same candidates and ts_order")
    if not torch.equal(first[1], f_cpu):
        j = next(j for name, j in FEATURE_INDEX.items()
                 if not torch.equal(first[1][..., j], f_cpu[..., j]))
        name = FEATURE_NAMES[j]
        first_run = describe(name, j, first[1][..., j], f_cpu[..., j],
                             first[1][..., j] != f_cpu[..., j], "CPU's second run")
        print(f"# fault 1 recurred: the CPU's first run of the batch (seed {seed}) "
              f"differs from its second in {first_run}", flush=True)
    require(torch.equal(c_cpu, c_dev), "cross-check candidates bit-equal")
    require(torch.equal(t_cpu, t_dev), "cross-check ts_order bit-equal")
    n_cand = int((c_cpu >= 0).sum())
    require(n_cand > 10 * S, f"cross-check has candidates ({n_cand})")
    worst = 0.0
    for name, j in FEATURE_INDEX.items():
        a, b = f_cpu[..., j], f_dev[..., j]
        if name in FLOAT_FEATURES:
            bad = ~torch.isclose(a, b, rtol=FLOAT_TOL, atol=FLOAT_TOL)
            if bad.any():
                raise RuntimeError(f"check failed: cross-check within {FLOAT_TOL}, "
                                   + describe(name, j, a, b, bad, "card"))
            worst = max(worst, float((a - b).abs().max()))
        else:
            require(torch.equal(a, b), f"cross-check {name} bit-equal")
    if not quiet:
        print(f"# cross-check: {S} sessions, {n_cand} candidates bit-equal, "
              f"integer features bit-equal, float features max |diff| {worst:.3g} "
              f"(tolerance {FLOAT_TOL}); the CPU's first and second runs "
              f"{'differ (fault 1, above)' if first_run else 'bit-equal'}")
    return p.session[:S], ctx_cpu, ev, (c_dev, f_dev, t_dev), first_run


def phase_cross_check(dev):
    from otto_tpu_torch.data.batching import pack_sessions
    from otto_tpu_torch.engine.session_embed import compute_session_embeddings
    from otto_tpu_torch.ops import kmeans
    from otto_tpu_torch.ops.knn import knn_search

    cpu = torch.device("cpu")
    sessions, ctx_cpu, ev, (cand, feats, _), _ = cross_check_retrieval(dev, SEED + 1)
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
    cross_check_mlp(dev)
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
                    ev.finalize(labels), sel, np.asarray(rows)))
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


def mlp_batches(rng, B, G, F, src, n=3):
    """n seeded batches (feats [B, G, F] of mixed scales with src_* flags,
    labels, mask) shaped as pass A's padded groups: padding all zero."""
    out = []
    for _ in range(n):
        mask = rng.random((B, G)) < 0.7
        feats = (rng.standard_normal((B, G, F)) * rng.choice([1.0, 30.0, 1e4], F)
                 ).astype(np.float32)
        feats[..., src] = rng.random((B, G, len(src))) < 0.3
        feats[~mask] = 0.0
        labels = ((rng.random((B, G)) < 0.05) & mask).astype(np.float32)
        out.append(tuple(torch.from_numpy(a) for a in (feats, labels, mask)))
    return out


def cross_check_mlp(dev):
    """The MLP tower on the card against the CPU from the same weights,
    pointwise and listwise, at RankerConfig() width (104 features,
    256-128-64, [32, 128, 104] batches) and on a small case (32-16 hidden,
    [8, 64, 104]): scores within MLP_SCORE_RTOL relative + MLP_SCORE_ATOL,
    and three AdamW steps on the same batches under the same schedule
    with weights within MLP_STEP_ATOL. The output bias shifts every score
    alike, so the loss does not see it: its gradient is rounding noise,
    which Adam turns into a step of about the rate either way, and it is
    held within the rates' sum."""
    import copy

    from otto_tpu_torch.config import RankerConfig
    from otto_tpu_torch.engine.retrieval import FEATURE_NAMES
    from otto_tpu_torch.models import ranker as mlp

    cpu, F = torch.device("cpu"), len(FEATURE_NAMES)
    devices = {"cpu": cpu, "card": dev}
    src = np.array([i for i, n in enumerate(FEATURE_NAMES) if n.startswith("src_")])
    for listwise in (False, True):
        rng = np.random.default_rng(SEED)
        msg = []
        for hidden, B, G in (((256, 128, 64), 32, 128), ((32, 16), 8, 64)):
            cfg = RankerConfig(hidden_dims=hidden)
            lr = mlp.lr_schedule(cfg, 6)
            batches = mlp_batches(rng, B, G, F, src)
            mean, std = mlp.compute_norm_stats(batches[0][0].numpy().reshape(-1, F))
            towers = {"cpu": mlp.init_ranker(F, cfg, mean, std,
                                             src_idx=src if listwise else None)}
            towers["card"] = copy.deepcopy(towers["cpu"]).to(dev)
            with torch.no_grad():
                s = {k: towers[k](batches[0][0].to(d)).cpu() for k, d in devices.items()}
            d = (s["card"] - s["cpu"]).abs()
            require(bool((d <= MLP_SCORE_RTOL * s["cpu"].abs() + MLP_SCORE_ATOL).all()),
                    f"MLP {hidden} scores within tolerance (listwise {listwise})")
            for k, dv in devices.items():
                opt = mlp.make_optimizer(towers[k], cfg)
                for i, batch in enumerate(batches):
                    mlp.train_step(towers[k], opt, tuple(x.to(dv) for x in batch), lr(i),
                                   cfg.sigma, cfg.eval_at)
            pairs = list(zip(towers["card"].weights(), towers["cpu"].weights()))
            err = max([float(np.abs(a - b).max()) for (a, _), (b, _) in pairs]
                      + [float(np.abs(a - b).max()) for (_, a), (_, b) in pairs[:-1]])
            out_bias = float(np.abs(pairs[-1][0][1] - pairs[-1][1][1]).max())
            msg.append(f"{hidden} on [{B}, {G}, {F}]: scores max |diff| {float(d.max()):.3g} "
                       f"({int((d > 0).sum())} of {d.numel()} differ), after 3 steps weights "
                       f"max |diff| {err:.3g}, output bias {out_bias:.3g}")
            require(err <= MLP_STEP_ATOL,
                    f"MLP {hidden} weights after 3 steps within {MLP_STEP_ATOL}: {err:.3g}")
            require(out_bias <= sum(lr(i) for i in range(3)),
                    "MLP output bias within the rates")
        print(f"# cross-check MLP (listwise {listwise}): " + "; ".join(msg))


def cross_check_sgns(dev):
    """SGNS on the card against the CPU from the same draws (made on the
    CPU, copied to both) and the same seeded state: one block step (16384
    centers x 4, 8 negatives, 100-d) with Adagrad and one with plain SGD
    (the accumulators left alone), and one pair step (65536 pairs) with
    their tables and accumulators within SGNS_RTOL / SGNS_ATOL; then two
    card trainings of a small corpus in each step kind, bit-identical."""
    from otto_tpu_torch.config import Word2VecConfig
    from otto_tpu_torch.data.synthetic import SyntheticSpec, generate_device
    from otto_tpu_torch.models import word2vec as w2v

    cpu = torch.device("cpu")
    n_aids = 50_000
    ev = generate_device(SyntheticSpec(n_sessions=20_000, n_aids=n_aids, max_len=128,
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
        if kind in ("block", "block sgd"):
            # plain SGD at otto_tpu's starting rate (sgd_alpha)
            sgd = kind == "block sgd"
            loss = w2v._block_step(p, x["words"], x["pos_info"], x["prob"], x["alias"],
                                   x["keep"], 0.025 if sgd else 0.25, 4, 8,
                                   {k: v.to(device) for k, v in block.items()},
                                   "sgd" if sgd else "adagrad")
        else:
            loss = w2v._pair_step(p, x["words"], x["cum"], x["cdf"], x["keep"], 0.25,
                                  65536, 8, {k: v.to(device) for k, v in pair.items()},
                                  "pair")
        return [t.cpu() for t in p], float(loss)

    for kind in ("block", "block sgd", "pair"):
        (got, loss_d), (want, loss_c) = step(dev, kind), step(cpu, kind)
        errs = []
        for name, a, b, s0 in zip(w2v.SGNSParams._fields, got, want, state):
            require(torch.allclose(a, b, rtol=SGNS_RTOL, atol=SGNS_ATOL),
                    f"SGNS {kind} step {name} within {SGNS_RTOL} / {SGNS_ATOL}")
            moved = int((b != s0).reshape(V, -1).any(1).sum())
            errs.append(f"{name} {float((a - b).abs().max()):.3g} ({moved} rows moved)")
        require(abs(loss_d - loss_c) <= SGNS_RTOL * abs(loss_c), f"SGNS {kind} loss")
        if kind == "block sgd":
            require(torch.equal(got[2], state[2]) and torch.equal(got[3], state[3]),
                    "SGNS block sgd step leaves the accumulators alone")
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
    from otto_tpu_torch.data.synthetic import SyntheticSpec, generate_device
    from otto_tpu_torch.engine import baseline
    from otto_tpu_torch.engine.covis import CoVisCounter
    from otto_tpu_torch.engine.popularity import compute_popularity

    cpu = torch.device("cpu")
    n_aids = 20_000
    sp = split_events(generate_device(SyntheticSpec(
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
    with tempfile.TemporaryDirectory() as root:
        work = os.path.join(root, "work")
        sp, retriever, build_launches = phase_table_build(dev, smi, work)
        torch.cuda.empty_cache()
        rankers, pa_launches, tr_launches, pa_metrics = phase_training(
            dev, smi, sp, retriever, work)
        torch.cuda.empty_cache()
        phase_sgns_paths(dev, smi, sp)
        torch.cuda.empty_cache()
        serve_launches, serve_recall, base_recall = phase_main_path(
            dev, smi, sp, retriever, rankers, pa_metrics)
        torch.cuda.empty_cache()
        hstu_launches = phase_hstu(dev, smi, sp, retriever)
        torch.cuda.empty_cache()
        mla_launches = phase_mla_moe(dev, smi, sp, retriever)
        torch.cuda.empty_cache()
        mlp_tr_launches, mlp_launches = phase_mlp(dev, smi, sp, retriever, work, pa_metrics,
                                                  serve_recall, base_recall)
        torch.cuda.empty_cache()
        batch_launches, batch_ref = phase_batch_runner(dev, smi, sp, retriever, work,
                                                       serve_recall)
        ctx = retriever.ctx
        pop = tuple(t.cpu().numpy() for t in (ctx.pop_cl50_cand, ctx.pop_cl50_ranks,
                                              ctx.pop_cl1_rank))
        del retriever, ctx
        torch.cuda.empty_cache()
        tool_launches = phase_tool(smi, sp, root)
        torch.cuda.empty_cache()
        mesh_launches = phase_multi_device(smi, sp, work, pop, UNSHARDED.pop("preds"),
                                           serve_recall, UNSHARDED, batch_ref)
        torch.cuda.empty_cache()
        fullscale_launches = phase_fullscale(smi, root)
    phase_cross_check(dev)

    w = WALK
    print(f"# K1 at the tree walk's shape {w['shape']}: {w['ms']:.3f} ms, bound "
          f"{w['bound_ms']:.3f} ms by {w['bound_by']} ({100 * w['bound_ms'] / w['ms']:.0f}% "
          f"of it), twin {w['plain_ms']:.3f} ms, torch.gather {w['library_ms']:.3f} ms; "
          f"launches in the walk: serving {w['launches']['serving']}, training "
          f"{w['launches']['training']} ({smi})")
    # launches on the paths this script drives: the build (K3, K4), pass A,
    # training, serving, the MLP's training and serving, the batch runner
    # (K1, K2), the two CLI runs (all), the multi-device stages (all, every
    # rank) and the reference-scale script (all)
    paths = {k: sum(p[k] for p in (build_launches, pa_launches, tr_launches,
                                   serve_launches, hstu_launches, mla_launches,
                                   mlp_tr_launches, mlp_launches,
                                   batch_launches, tool_launches, mesh_launches,
                                   fullscale_launches))
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
        "gbdt_walk": ("otto_tpu_torch/csrc/gbdt_walk.cu",
                      "none; subsumes the walk of otto_tpu/models/gbdt.py:425"),
        "hstu_attention": ("otto_tpu_torch/csrc/hstu_attention.cu",
                           "none; the HSTU ranker exists only in the port"),
        "retrieval_features": ("otto_tpu_torch/csrc/retrieval_features.cu",
                               "none; otto_tpu's Stage E is XLA ops under jit"),
        "retrieval_columns": ("otto_tpu_torch/csrc/retrieval_columns.cu",
                              "none; otto_tpu's Stage D is XLA ops under jit"),
        "grouped_gemm": ("otto_tpu_torch/csrc/grouped_gemm.cu",
                         "none; the MLA + MoE ranker exists only in the port"),
        "softmax_attention": ("otto_tpu_torch/csrc/hstu_attention.cu",
                              "none; the MLA + MoE ranker exists only in the port"),
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
