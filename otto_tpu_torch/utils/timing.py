"""Timing and profiling.

Counterpart of otto_tpu/utils/timing.py: `time_fn` (first call apart from
the steady-state runs), `StageTimer` and `profiler_trace`. A function
whose output holds CUDA tensors is timed with CUDA events around each
run; otherwise with the host clock. `device_sync` is
`torch.cuda.synchronize`: on a local card it waits for the device
truthfully, so otto_tpu's dependent-scalar sync and its round-trip
correction (`sync_overhead`) have nothing to do here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List

import torch


def _cuda_devices(out) -> set:
    """The CUDA devices of the tensors in a (nested) output."""
    found = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                found.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(out)
    return found


def device_sync(out) -> None:
    """Wait for the CUDA devices that hold `out`'s tensors; nothing for CPU
    outputs."""
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class TimingResult:
    name: str
    compile_s: float          # the first call, warm-up included
    mean_s: float
    std_s: float
    runs: List[float]

    @property
    def per_second(self) -> float:
        return 1.0 / self.mean_s if self.mean_s > 0 else float("inf")

    def items_per_second(self, items: int) -> float:
        return items / self.mean_s if self.mean_s > 0 else float("inf")


def time_fn(
    name: str,
    fn: Callable,
    *args,
    iters: int = 5,
    warmup: int = 1,
    **kwargs,
) -> TimingResult:
    """Time `fn(*args, **kwargs)`: the first call (CUDA context, kernel
    builds, caches) is `compile_s`, then `warmup - 1` more untimed calls,
    then `iters` timed runs. Runs whose output lies on a card are timed by
    CUDA events on the current stream (the seconds between the launch of
    its first and the end of its last kernel); others by the host clock."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    device_sync(out)
    compile_s = time.perf_counter() - t0
    for _ in range(warmup - 1):
        device_sync(fn(*args, **kwargs))
    on_card = bool(_cuda_devices(out))
    runs = []
    for _ in range(iters):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / 1e3)
        else:
            t = time.perf_counter()
            fn(*args, **kwargs)
            runs.append(time.perf_counter() - t)
    mean = sum(runs) / len(runs)
    std = (sum((r - mean) ** 2 for r in runs) / len(runs)) ** 0.5
    return TimingResult(name, compile_s, mean, std, runs)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """A torch.profiler trace of the block (CPU and, where CUDA is up, the
    card's activity), written to `log_dir` for TensorBoard; yields the
    profiler, whose key_averages() sums the ops and kernels by name."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


class StageTimer:
    """Accumulates named stages' wall-clock seconds."""

    def __init__(self):
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"{name}: {s:.2f}s ({s / total * 100:.0f}%)"
                 for name, s in sorted(self.stages.items(), key=lambda kv: -kv[1])]
        return "\n".join(lines + [f"total: {total:.2f}s"])
