"""Timing, profiling, and the program's own spans and counters.

Counterpart of otto_tpu/utils/timing.py: `time_fn` (first call apart from
the steady-state runs), `StageTimer` and `profiler_trace`. A function
whose output holds CUDA tensors is timed with CUDA events around each
run; otherwise with the host clock. `device_sync` is
`torch.cuda.synchronize`: on a local card it waits for the device
truthfully, so otto_tpu's dependent-scalar sync and its round-trip
correction (`sync_overhead`) have nothing to do here.

Spans and counters (the port's own; otto_tpu has none):

- `request(name)` opens one request's root span (`score_pass` opens
  `otto::runner.score_pass`). The request records when, as it starts,
  torch.profiler is on for the calling thread, or the call runs inside a
  `recording()` block; otherwise it and every span under it cost one
  flag check. `current_request()` and `joined(req)` carry a request to a
  worker thread (pipelined_consume's consumer).
- `span(name, batch=None)`: a span of the calling thread's request, named
  `otto::<layer>.<what>`, stamped with `time.time_ns()` (the host clock
  on which torch.profiler stamps its ranges), with its thread, parent
  span, request id and batch index (a child without one takes its
  parent's). On the thread that runs the profiler it is also a profiler
  range of its name (the profiler records no range of another thread),
  of the operators' kind, which the profiler does not copy onto the
  device's timeline. A `with` block, or `open()` / `then(name)` /
  `close()` for a run of stages; a span closes the spans it opened that
  are still open.
- The registry keeps per-name counts and seconds (`span_totals()`) and
  the last `RING_SPANS` spans (`spans()`; `dropped()` counts those that
  fell out), in memory only; `reset_spans()` empties it.
- `counter(name)`: a named count, always on (the kernels' launches).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

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


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------
RING_SPANS = 1 << 16


class SpanRecord(NamedTuple):
    name: str
    start_ns: int         # time.time_ns(), the profiler's host clock
    end_ns: int
    thread: str           # the thread's name
    id: int
    parent: Optional[int]  # the enclosing span's id, None for a request's root
    request: int
    batch: Optional[int]  # RetrievedBatch.index where the span has one
    index: Optional[int] = None  # the span's place among its siblings of one name


class Counter:
    """A named count, safe to add to from several threads."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def add(self, n: int = 1) -> None:
        with _lock:
            self.value += n

    def reset(self) -> None:
        with _lock:
            self.value = 0


_lock = threading.Lock()
_totals: Dict[str, List[int]] = {}                   # name -> [count, ns]
_ring: "collections.deque[SpanRecord]" = collections.deque(maxlen=RING_SPANS)
_closed = 0                                          # spans recorded since the reset
_counters: Dict[str, Counter] = {}
_span_ids = itertools.count()
_request_ids = itertools.count()
_recording = 0     # open recording() blocks
_active = 0        # recording requests open on any thread


class Request(NamedTuple):
    """A recording request: its id, and its root span's id (the parent of
    a worker thread's first span)."""
    id: int
    root: int


class _Thread(threading.local):
    """The calling thread's request, its open spans, and whether its spans
    are profiler ranges too."""
    req: Optional[Request] = None
    stack: Optional[list] = None
    profiled = False


_here = _Thread()


class _NoSpan:
    """The span handed out while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def open(self):
        return self

    def then(self, name: str):
        return self

    def close(self) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "batch", "index", "id", "parent", "start", "range")

    def __init__(self, name: str, batch: Optional[int], id: Optional[int] = None,
                 index: Optional[int] = None):
        self.name = name
        self.batch = batch
        self.index = index
        self.id = id
        self.range = None

    def __enter__(self):
        return self.open()

    def __exit__(self, *exc):
        self.close()
        return False

    def open(self) -> "_Span":
        stack = _here.stack
        top = stack[-1] if stack else None
        if self.id is None:
            self.id = next(_span_ids)
        if top is not None:
            self.parent = top.id
            if self.batch is None:
                self.batch = top.batch
        else:   # a worker thread's first span hangs under the request's root
            root = _here.req.root
            self.parent = root if root != self.id else None
        stack.append(self)
        if _here.profiled:
            # an operator-kind range: record_function's user annotations are
            # mirrored onto the device's timeline as if they were device work
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
        # stamped inside the profiler's range, so that the two start and end
        # together and the range's own cost is left out
        self.start = time.time_ns()
        return self

    def then(self, name: str) -> "_Span":
        """Close this span and open its successor `name`."""
        self.close()
        return _Span(name, None).open()

    def close(self) -> None:
        global _closed
        stack = _here.stack
        if not stack or self not in stack:
            return                      # closed already
        while stack[-1] is not self:    # left open by an exception
            stack[-1].close()
        stack.pop()
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        rec = SpanRecord(self.name, self.start, end, threading.current_thread().name,
                         self.id, self.parent, _here.req.id, self.batch, self.index)
        with _lock:
            tot = _totals.get(self.name)
            if tot is None:
                tot = _totals[self.name] = [0, 0]
            tot[0] += 1
            tot[1] += end - self.start
            _ring.append(rec)
            _closed += 1


def span(name: str, batch: Optional[int] = None, index: Optional[int] = None):
    """A span of the calling thread's request (a shared no-op while none
    records): `with span(...):`, or `span(...).open()` ... `.close()`.
    `index` numbers repeated spans of one name (an encoder's blocks)."""
    if not _active or _here.req is None:
        return _NO_SPAN
    return _Span(name, batch, index=index)


@contextlib.contextmanager
def recording():
    """Record every request that starts inside the block, whether or not
    torch.profiler is on."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def current_request() -> Optional[Request]:
    """The request the calling thread records into, or None."""
    return _here.req


@contextlib.contextmanager
def _adopt(req: Request, profiled: bool):
    global _active
    with _lock:
        _active += 1
    _here.req, _here.stack, _here.profiled = req, [], profiled
    try:
        yield
    finally:
        if _here.stack:
            _here.stack[0].close()      # with every span under it
        _here.req, _here.stack, _here.profiled = None, None, False
        with _lock:
            _active -= 1


@contextlib.contextmanager
def request(name: str):
    """One request: its root span `name`, when it records (see the module
    docstring). A request started inside another one is a span of it.
    Yields the Request, or None when it does not record."""
    if _here.req is not None:
        with span(name):
            yield _here.req
        return
    profiled = torch.autograd._profiler_enabled()
    if not (_recording or profiled):
        yield None
        return
    root = next(_span_ids)
    req = Request(next(_request_ids), root)
    with _adopt(req, profiled), _Span(name, None, root):
        yield req


@contextlib.contextmanager
def joined(req: Optional[Request]):
    """Record the block on the calling thread into request `req` (started
    on another thread; its spans here are no profiler ranges). None: no-op."""
    if req is None:
        yield
        return
    with _adopt(req, False):
        yield


def span_totals() -> Dict[str, Tuple[int, float]]:
    """{span name: (spans closed, seconds in them)} since the last reset."""
    with _lock:
        return {k: (c, ns * 1e-9) for k, (c, ns) in _totals.items()}


def spans() -> List[SpanRecord]:
    """The last RING_SPANS spans closed, in the order they closed."""
    with _lock:
        return list(_ring)


def dropped() -> int:
    """Spans closed since the last reset that the ring no longer holds."""
    with _lock:
        return _closed - len(_ring)


def reset_spans() -> None:
    global _closed
    with _lock:
        _totals.clear()
        _ring.clear()
        _closed = 0


def counter(name: str) -> Counter:
    """The counter `name`, made at its first use."""
    with _lock:
        c = _counters.get(name)
        if c is None:
            c = _counters[name] = Counter(name)
        return c
