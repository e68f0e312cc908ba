"""The traced run's probe: spans from the benchmark's own files around
the calls into each layer, the kernels' call shapes, and torch.profiler
over a bounded slice of the window, held in memory and reduced to a
summary that the readers in benchmark/metrics/ take their numbers from.

While the probe is on:
- `otto_tpu_torch.engine.retrieval.retrieve_batch` (which
  `Retriever.iter_run` calls) and `otto_tpu_torch.engine.rank
  .score_topk_multi` (which `score_pass`'s consumer calls) run inside
  `record_function` ranges (the consumer thread's are not recorded:
  torch.profiler follows the thread that started it);
- a one-cycle marker kernel on the calling thread's stream, launched and
  waited for as the slice opens, names the producer's stream: the
  producer (`Retriever.iter_run`: its copies and `retrieve_batch`) works
  on it, and `pipelined_consume`'s consumer (`score_topk_multi` and the
  pulls) on a stream of its own, so device time splits by stream;
- `otto_tpu_torch.pipeline.runner.pipelined_consume` hands back its
  produce / consume / wait seconds;
- kernel K1's callers (`ops/segment.py`, `models/gbdt.py`) and K2's
  (`ops/segment.py`) record every call's shape, from which
  benchmark/peaks.py counts the bytes each call needs;
- the consumer sums the valid candidate rows it scores, on the card.
"""
from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from typing import Dict, List

import torch

from benchmark import peaks
from benchmark.reference.retrieval import FEATURE_NAMES

MARK = "spin_kernel"           # the kernel of torch.cuda._sleep
K1_NAME = "gather_rows_kernel"
K2_NAME = "segscan_kernel"


class Probe:
    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.active = False
        self.summary: Dict = {}
        self._undo: List = []
        self._lock = threading.Lock()
        self.runner = defaultdict(float)
        self.k1_bytes = 0
        self.k2_bytes = 0
        self.k1_calls = 0
        self.k2_calls = 0
        self.rows = None
        self.prof = None

    # ---- patches ---------------------------------------------------------
    def _patch(self, module, name, make):
        orig = getattr(module, name)
        setattr(module, name, make(orig))
        self._undo.append((module, name, orig))

    def _install(self):
        from otto_tpu_torch.engine import rank, retrieval
        from otto_tpu_torch.models import gbdt
        from otto_tpu_torch.ops import segment
        from otto_tpu_torch.pipeline import runner

        def marked(label):
            def make(fn):
                def call(*a, **kw):
                    with torch.profiler.record_function(label):
                        return fn(*a, **kw)
                return call
            return make

        def counted_rank(fn):
            inner = marked("bench::rank")(fn)

            def call(b, *a, **kw):
                n = (b.cand_device() >= 0).sum()
                with self._lock:
                    self.rows = n if self.rows is None else self.rows + n
                return inner(b, *a, **kw)
            return call

        def consume_seconds(fn):
            def call(*a, **kw):
                with torch.profiler.record_function("bench::pipelined_consume"):
                    sec = fn(*a, **kw)
                for k, v in sec.items():
                    self.runner[k] += v
                return sec
            return call

        def k1(fn):
            def call(values, idx, check=False):
                out = fn(values, idx, check)
                if idx.device.type == "cuda" and out.numel():
                    B, S, W = out.shape
                    P = values[0].shape[-1]
                    with self._lock:
                        self.k1_bytes += peaks.k1_bytes(B, S, P, W)
                        self.k1_calls += 1
                return out
            return call

        def k2(fn):
            def call(values, first, red):
                out = fn(values, first, red)
                if values.device.type == "cuda" and out.numel():
                    with self._lock:
                        self.k2_bytes += peaks.k2_bytes(*values.shape)
                        self.k2_calls += 1
                return out
            return call

        self._patch(retrieval, "retrieve_batch", marked("bench::retrieval"))
        self._patch(rank, "score_topk_multi", counted_rank)
        self._patch(runner, "pipelined_consume", consume_seconds)
        self._patch(segment, "gather_rows", k1)
        self._patch(gbdt, "gather_rows", k1)
        self._patch(segment, "segmented_scan", k2)

    def _uninstall(self):
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        self._undo.clear()

    # ---- the slice -------------------------------------------------------
    def start(self):
        self._install()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        if torch.cuda.is_available():
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self.active = True

    def stop(self, sessions: int):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self._uninstall()
        self.active = False
        rows = int(self.rows) if self.rows is not None else 0
        self.summary = summarize(self.prof, window_s)
        r = self.cfg["ranker"]
        if self.cfg["ranker_backend"] == "gbdt":
            ops = peaks.gbdt_ops(rows, r["n_trees"], r["max_depth"])
            peak = peaks.FP32_FLOPS
        else:
            dims = [len(FEATURE_NAMES), *r["hidden_dims"], 1]
            ops = peaks.mlp_flops(rows, dims)
            peak = peaks.FP64_TENSOR_FLOPS
        self.summary.update({
            "sessions": sessions, "rows": rows, "rank_ops": ops * r["n_rankers"],
            "rank_peak": peak, "runner": dict(self.runner),
            "k1_bytes": self.k1_bytes, "k1_calls": self.k1_calls,
            "k2_bytes": self.k2_bytes, "k2_calls": self.k2_calls,
        })
        self.prof = None


def _kind(e) -> str:
    """The event's activity type where this torch's profiler names it."""
    fn = getattr(e, "activity_type", None)
    return fn() if fn is not None else ""


def _merge(iv):
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(prof, window_s: float) -> Dict:
    """Device time by kernel, by stream and in all; the idle gaps by what
    the host was doing. The producer's stream is the one that ran the
    first marker kernel."""
    events = prof.profiler.kineto_results.events()
    dev_ev, host_ev = [], []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the device's copies of the host's ranges are no operations
            if e.duration_ns() > 0 and not e.name().startswith("bench::") \
                    and _kind(e) != "gpu_user_annotation":
                dev_ev.append(e)
        else:
            host_ev.append(e)
    by_kernel: Dict[str, float] = defaultdict(float)
    by_stream: Dict[int, float] = defaultdict(float)
    producer, first_mark = None, None
    iv = []
    for e in dev_ev:
        s, d = e.start_ns(), e.duration_ns()
        if MARK in e.name():
            if first_mark is None or s < first_mark:
                first_mark, producer = s, e.device_resource_id()
            continue
        by_kernel[e.name()] += d * 1e-9
        by_stream[e.device_resource_id()] += d * 1e-9
        iv.append((s, s + d))
    merged = _merge(iv)
    busy = sum(e - s for s, e in merged) * 1e-9
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    out = {
        "window_s": window_s, "busy_s": busy, "device_ops": [[k, v] for k, v in top],
        "streams": {str(k): v for k, v in by_stream.items()},
        "k1_s": sum(v for k, v in by_kernel.items() if K1_NAME in k),
        "k2_s": sum(v for k, v in by_kernel.items() if K2_NAME in k),
        "idle_gaps": _idle_gaps(merged, host_ev),
    }
    if producer is not None:
        out["retrieval_s"] = by_stream.get(producer, 0.0)
        out["rank_s"] = sum(v for k, v in by_stream.items() if k != producer)
    return out


def _idle_gaps(merged, host_ev, top: int = 10):
    """The device's idle gaps inside the slice, summed by the innermost host
    range (benchmark span or operator) open at each gap's middle."""
    ops = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in host_ev if e.duration_ns() > 0), key=lambda x: x[0])
    starts = [o[0] for o in ops]
    by: Dict[str, float] = defaultdict(float)
    for (_, e0), (s1, _) in zip(merged[:-1], merged[1:]):
        gap = (s1 - e0) * 1e-9
        mid = (e0 + s1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = "host: no operator open"
        for j in range(i, max(-1, i - 400), -1):
            if ops[j][1] >= mid:
                label = ops[j][2]
                break
        by[label] += gap
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
