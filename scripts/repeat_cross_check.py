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
temporary work dir, made under OTTO_HISTORY_DIR when it is set: ~5 GB
of artifact cache and rows a process), pass A over every test session
and three rankers (`--trees` trees each) from its rows, and a score_pass
over every test session (phase 5's path). Needs a CUDA device.

Probes of fault 1 at the first check (the one that has failed):
`--first-threads N` runs that check with `torch.set_num_threads(N)`;
`--locate` records every float32 `torch.einsum` and `torch.linalg.norm`
call of the first CPU retrieval run (the terms of eucl_dist_ses_aid: the
dot products, the session norms and the candidate norms) and prints the
largest error of each against float64 on the same inputs, split into the
calling thread's share of the rows (the first 1/threads) and the rest.
`--trace-ops` hashes every aten op's CPU output in the first check's two
CPU runs (8 blocks along the first dimension) and prints the ops whose
outputs differ, in order. The calling thread's CPU math state (threads, oneDNN and float32
precision settings, CPU capability, autocast and grad modes, MXCSR) is
printed before and after the history, and so are the MXCSR and
fegetround() of every thread of an OpenMP parallel region as wide as
torch's intra-op pool (scripts/thread_fp_state.cc, built with -fopenmp by
ops/kernels/_build.py::build_host; the line names the libgomp that served
the region, torch's when it is the one in torch/lib). The first check
always keeps the input and output of every CPU float32 `torch.sqrt` of
its two CPU runs (the tail of eucl_dist_ses_aid: `n_s**2 + n_c**2 -
2*dot` after the clamp, then the root) and the roots of its card run,
and, when the first run differs from the second, recomputes the root of
the kept input on the spot: it prints whether the input to sqrt differed
between the runs or the root of an equal input did, and how the wrong
roots compare with the card's roots of the same entries.
"""
import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def history(dev, smi, trees):
    """chip_smoke.py's phases 3 to 5, the rankers cut to `trees` trees."""
    from otto_tpu_torch.config import TYPES, Config, GBDTConfig, RankerConfig
    from otto_tpu_torch.pipeline.runner import load_downsampled, pass_a, score_pass, \
        train_ranker_cached

    t0 = time.perf_counter()
    chip_smoke.phase_kernels(dev, smi)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.environ.get("OTTO_HISTORY_DIR")) as root:
        work = os.path.join(root, "work")
        sp, retriever, _ = chip_smoke.phase_table_build(dev, smi, work)
        pass_a(retriever, sp.test, sp.labels, RankerConfig(), work,
               batch_sessions=chip_smoke.BATCH)
        rankers = {t: train_ranker_cached(work, t, lambda t=t: load_downsampled(work, t),
                                          Config(gbdt=GBDTConfig(n_trees=trees)), dev,
                                          use_cache=False)
                   for t in TYPES}
        preds = score_pass(retriever, sp.test, rankers, chip_smoke.BATCH)
        n = len(preds["clicks"][0])
    del retriever
    torch.cuda.empty_cache()
    print(f"# history: kernels, build, pass A, {trees}-tree rankers and a score_pass over "
          f"{n} sessions in {time.perf_counter() - t0:.1f} s", flush=True)


def _mxcsr():
    """The calling thread's MXCSR (SSE rounding mode, flush-to-zero,
    denormals-are-zero), read by a two-line helper that the host compiler
    builds in a temporary directory; None without a compiler."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        return None
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "mxcsr.c"), os.path.join(tmp, "libmxcsr.so")
        with open(src, "w") as f:
            f.write("unsigned otto_mxcsr(void) { return __builtin_ia32_stmxcsr(); }\n")
        if subprocess.run([cxx, "-x", "c", "-O1", "-fPIC", "-shared", "-o", lib, src],
                          capture_output=True).returncode:
            return None
        fn = ctypes.CDLL(lib).otto_mxcsr
        fn.restype = ctypes.c_uint
        return f"0x{fn():04x}"


def thread_fp_state():
    """{"library": libgomp path, "threads": [(tid, MXCSR, fegetround)]} of
    every thread of one OpenMP parallel region of torch.get_num_threads()
    threads; None without a host compiler."""
    from pathlib import Path

    from otto_tpu_torch.ops.kernels import _build

    try:
        lib = ctypes.CDLL(str(_build.build_host(
            Path(__file__).with_name("thread_fp_state.cc"), ("-fopenmp",))))
    except RuntimeError:
        return None
    n = torch.get_num_threads()
    mx, rd, tid = (ctypes.c_uint * n)(), (ctypes.c_int * n)(), (ctypes.c_long * n)()
    lib.otto_thread_fp_state.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_uint),
                                         ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_long)]
    lib.otto_thread_fp_state.restype = ctypes.c_int
    seen = lib.otto_thread_fp_state(n, mx, rd, tid)
    lib.otto_omp_library.argtypes = []
    lib.otto_omp_library.restype = ctypes.c_char_p
    return {"library": lib.otto_omp_library().decode(), "seen": seen,
            "threads": [(tid[i], f"0x{mx[i]:04x}", rd[i]) for i in range(n)]}


def math_state(when):
    """Print the calling thread's CPU math state and that of every thread
    of an OpenMP region as wide as torch's intra-op pool."""
    mk = torch.backends.mkldnn
    state = {
        "threads": torch.get_num_threads(), "interop_threads": torch.get_num_interop_threads(),
        "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS"),
        "cpu_capability": torch.backends.cpu.get_cpu_capability(),
        "mkldnn": (mk.is_available(), mk.enabled),
        "mkldnn.matmul.fp32_precision": getattr(getattr(mk, "matmul", None), "fp32_precision", None),
        "mkldnn.conv.fp32_precision": getattr(getattr(mk, "conv", None), "fp32_precision", None),
        "fp32_precision": getattr(torch.backends, "fp32_precision", None),
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "autocast_cpu": (torch.is_autocast_enabled("cpu"), str(torch.get_autocast_dtype("cpu"))),
        "grad": torch.is_grad_enabled(), "inference_mode": torch.is_inference_mode_enabled(),
        "flush_denormal_mxcsr": _mxcsr(),
    }
    print(f"# math state {when}: {json.dumps(state, default=str)}", flush=True)
    print(f"# worker threads' fp state {when} (tid, MXCSR, fegetround): "
          f"{json.dumps(thread_fp_state())}", flush=True)


class KeepTail:
    """Keeps the input and output of every float32 torch.sqrt in the first
    two CPU retrieve_batch calls (the first check's two CPU runs: the tail
    of eucl_dist_ses_aid) and the output of those in its card run. report()
    says, for a first run that differed, whether sqrt's input differed or
    its root of an equal input, recomputing the root of the kept input
    now, and holds the wrong roots to the card's roots of the same entries
    (equal bits there would mean the card's values reached the CPU run's
    memory)."""

    def __init__(self):
        from otto_tpu_torch.engine import retrieval

        self.retrieval = retrieval
        self.inner = (torch.sqrt, retrieval.retrieve_batch)
        self.runs = []
        self.card = None
        self.armed = None   # the list the current run's sqrt calls go to

    def __enter__(self):
        sqrt, retrieve = self.inner

        def kept_sqrt(x, *a, **k):
            out = sqrt(x, *a, **k)
            if self.armed is not None and x.dtype == torch.float32:
                self.armed.append((x.clone().cpu(), out.clone().cpu()))
            return out

        def kept_runs(*a, **k):
            on_cpu = a[0][0].device.type == "cpu"
            if on_cpu and len(self.runs) < 2:
                self.runs.append([])
                self.armed = self.runs[-1]
            elif not on_cpu and self.card is None:
                self.card = []
                self.armed = self.card
            try:
                return retrieve(*a, **k)
            finally:
                self.armed = None
        torch.sqrt = kept_sqrt
        self.retrieval.retrieve_batch = kept_runs
        return self

    def __exit__(self, *exc):
        torch.sqrt, self.retrieval.retrieve_batch = self.inner

    def report(self):
        if len(self.runs) < 2:
            return
        card = self.card or []
        for k, ((x1, y1), (x2, y2)) in enumerate(zip(*self.runs)):
            d_in = x1 != x2
            d_out = y1 != y2
            again = torch.sqrt(x1)
            rows = d_out.reshape(d_out.shape[0], -1).any(1).nonzero()[:, 0].tolist()
            print(f"# tail sqrt {k} {tuple(x1.shape)}: inputs differ between the runs in "
                  f"{int(d_in.sum())} entries (max {float((x1 - x2).abs().max()):.3g}), "
                  f"roots in {int(d_out.sum())} (rows {rows[:40]}); the first run's roots "
                  f"against the root of its own input taken now: "
                  f"{int((y1 != again).sum())} differ (max "
                  f"{float((y1 - again).abs().max()):.3g}); roots of equal inputs that "
                  f"differ: {int((d_out & ~d_in).sum())} -> "
                  f"{'sqrt wrong' if bool((d_out & ~d_in).any()) else 'input to sqrt wrong' if bool(d_in.any()) else 'no difference here'}",
                  flush=True)
            if k < len(card) and card[k][1].shape == y1.shape and bool(d_out.any()):
                yc = card[k][1]
                w, r, c = y1[d_out], y2[d_out], yc[d_out]
                print(f"# tail sqrt {k} against the card's roots of the {int(d_out.sum())} "
                      f"entries that differ: wrong roots bit-equal to the card's in "
                      f"{int((w == c).sum())} (max |wrong - card| "
                      f"{float((w - c).abs().max()):.3g}), right roots in {int((r == c).sum())} "
                      f"(max |right - card| {float((r - c).abs().max()):.3g}); first "
                      f"entries (wrong, right, card): "
                      f"{list(zip(w[:4].tolist(), r[:4].tolist(), c[:4].tolist()))}",
                      flush=True)


class Locate:
    """Records the float32 CPU einsum / norm calls of the first CPU
    retrieve_batch and holds each to float64 on the same inputs."""

    def __init__(self):
        from otto_tpu_torch.engine import retrieval

        self.retrieval = retrieval
        self.inner = (torch.einsum, torch.linalg.norm, retrieval.retrieve_batch)
        self.armed = False
        self.done = False
        self.calls = []

    def _record(self, name, fn, args, kwargs):
        out = fn(*args, **kwargs)
        ts = [a for a in args if isinstance(a, torch.Tensor)]
        if self.armed and ts and all(t.device.type == "cpu" and t.dtype == torch.float32
                                     for t in ts):
            ref = fn(*[a.double() if isinstance(a, torch.Tensor) else a for a in args],
                     **kwargs)
            err = (out.double() - ref).abs()
            err = err / ref.abs().clamp(min=1e-6) if name == "norm" else err
            share = max(1, out.shape[0] // torch.get_num_threads()) if out.dim() else 1
            self.calls.append({
                "op": name, "shapes": [tuple(t.shape) for t in ts],
                "threads": torch.get_num_threads(),
                "calling_share_max": float(err[:share].max()) if err.numel() else 0.0,
                "rest_max": float(err[share:].max()) if err[share:].numel() else 0.0,
                "bad_rows": int((err.reshape(err.shape[0], -1).amax(1) > 1e-4).sum())
                if err.dim() else int(err > 1e-4)})
        return out

    def __enter__(self):
        einsum, norm, retrieve = self.inner
        torch.einsum = lambda *a, **k: self._record("einsum", einsum, a, k)
        torch.linalg.norm = lambda *a, **k: self._record("norm", norm, a, k)

        def first_cpu(*a, **k):
            arm = not self.done and a[0][0].device.type == "cpu"
            self.armed = arm
            try:
                return retrieve(*a, **k)
            finally:
                self.armed = False
                self.done = self.done or arm
        self.retrieval.retrieve_batch = first_cpu
        return self

    def __exit__(self, *exc):
        torch.einsum, torch.linalg.norm, self.retrieval.retrieve_batch = self.inner
        for c in self.calls:
            print(f"# locate (first CPU run): {json.dumps(c)}", flush=True)


class OpTrace:
    """Logs every aten op of the first two CPU retrieve_batch calls (the
    cross-check's first and second CPU runs of one batch) with a hash of
    each CPU output in 8 blocks of its first dimension, and prints the ops
    whose outputs differ between the two runs, in order, with the blocks
    that differ: the first of them is where the first run went wrong."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        from otto_tpu_torch.engine import retrieval

        logs = self.logs = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if "empty" in str(func):    # uninitialised memory
                    return out
                for t in torch.utils._pytree.tree_leaves(out):
                    if isinstance(t, torch.Tensor) and t.device.type == "cpu" and t.numel():
                        a = np.ascontiguousarray(t.detach().numpy())
                        blocks = a.view(np.uint8).reshape(t.shape[0] if t.dim() else 1, -1)
                        step = -(-blocks.shape[0] // 8)
                        logs[-1].append((str(func), tuple(t.shape), str(t.dtype), tuple(
                            hashlib.sha1(blocks[i:i + step].tobytes()).hexdigest()[:12]
                            for i in range(0, blocks.shape[0], step))))
                return out

        self.mode = Mode
        self.retrieval = retrieval
        self.inner = retrieval.retrieve_batch

    def __enter__(self):
        def traced(*a, **k):
            if len(self.logs) >= 2 or a[0][0].device.type != "cpu":
                return self.inner(*a, **k)
            self.logs.append([])
            with self.mode():
                return self.inner(*a, **k)
        self.retrieval.retrieve_batch = traced
        return self

    def __exit__(self, *exc):
        self.retrieval.retrieve_batch = self.inner
        if len(self.logs) < 2:
            return
        first, second = self.logs
        diff = [(i, f[0], f[1], f[2], [b for b, (x, y) in enumerate(zip(f[3], g[3])) if x != y])
                for i, (f, g) in enumerate(zip(first, second)) if f != g]
        print(f"# op trace: {len(first)} / {len(second)} CPU ops in the first / second run, "
              f"{len(diff)} outputs differ; first ones (index, op, shape, dtype, blocks of "
              f"8 along dim 0 that differ): {diff[:12]}", flush=True)
        if diff:
            i = diff[0][0]
            print(f"# op trace: the ops before the first difference: {first[max(0, i - 6):i]}",
                  flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=50)
    ap.add_argument("--history", action="store_true",
                    help="run chip_smoke.py's phases 3-5 first, in this process")
    ap.add_argument("--trees", type=int, default=25, help="trees a ranker in --history")
    ap.add_argument("--first-threads", type=int, default=0,
                    help="torch.set_num_threads for the first check (0: leave as is)")
    ap.add_argument("--locate", action="store_true",
                    help="hold the first CPU run's einsum / norm calls to float64")
    ap.add_argument("--trace-ops", action="store_true",
                    help="compare every CPU op's output between the first check's two CPU runs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("repeat_cross_check: no CUDA device", file=sys.stderr)
        return 2
    from otto_tpu_torch.device import pin_fp32, resolve

    dev = resolve("cuda")
    pin_fp32()
    smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    math_state("before the history")
    if args.history:
        history(dev, smi, args.trees)
    math_state("after the history")
    failures = []
    t0 = time.perf_counter()
    for i in range(args.runs):
        seed = chip_smoke.SEED + 1 + i
        threads = torch.get_num_threads()
        try:
            with contextlib.ExitStack() as stack:
                tail = stack.enter_context(KeepTail()) if i == 0 else None
                if i == 0 and args.locate:
                    stack.enter_context(Locate())
                if i == 0 and args.trace_ops:
                    stack.enter_context(OpTrace())
                if i == 0 and args.first_threads:
                    torch.set_num_threads(args.first_threads)
                    stack.callback(torch.set_num_threads, threads)
                first_run = chip_smoke.cross_check_retrieval(dev, seed, quiet=True)[-1]
            if first_run is not None and tail is not None:
                tail.report()
            if first_run is not None:
                failures.append({"seed": seed, "message": first_run})
        except RuntimeError as e:
            failures.append({"seed": seed, "message": str(e)})
            print(f"# seed {seed}: {e}", flush=True)
    print(json.dumps({"runs": args.runs, "history": args.history,
                      "first_threads": args.first_threads or torch.get_num_threads(),
                      "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS"),
                      "failures": len(failures),
                      "seeds_failed": [f["seed"] for f in failures],
                      "seconds": round(time.perf_counter() - t0, 1), "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
