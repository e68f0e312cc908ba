"""The port's own spans and counters (otto_tpu_torch/utils/timing.py) on
the serving path: score_pass records nothing unless torch.profiler or
`recording()` is on; its producer's spans are profiler ranges on the
profiler's clock; each thread's spans cover its time; every span of a
call carries the call's request id; a consumer error leaves no span open;
the benchmark's four span readers read the registry. The kernels' launch
counters are safe to add to from many threads. A tiny copy of the
benchmark's near-line cell on the CPU (the kernels' plain twins)."""
import importlib.util
import sys
import threading
from collections import defaultdict
from pathlib import Path

import pytest
import torch

from otto_tpu_torch.pipeline import runner
from otto_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmark import serve  # noqa: E402
from benchmark.tests.bench_tiny import tiny  # noqa: E402

BATCH = 16
READERS = ("retrieval.host_us", "rank.host_us", "rank.pull_us",
           "runner.consumer_wait_share")
PRODUCER = {"otto::retrieval.pack", "otto::retrieval.batch", "otto::runner.put_wait",
            "otto::runner.join", "otto::runner.assemble"}
CONSUMER = {"otto::runner.get_wait", "otto::runner.consume"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: torch's CPU pool only adds contention beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cell():
    """(retriever, events of one 24-session request, rankers): score_pass's
    first arguments."""
    _, cfg, _ = tiny("gbdt-nearline", n_trees=2)
    cfg.update(n_aids=500, test_sessions=200, batch_sessions=BATCH)
    cfg["retrieval"].update(max_session_aids=8, max_candidates=64,
                            session_len_buckets=[8, 32])
    cfg["tables"]["knn_first_n_aids"] = 400
    cfg["sessions"]["max_len"] = 32
    inp = serve.Inputs(cfg, 2**31 + 5, torch.device("cpu"))
    retriever, rankers = serve._port(cfg, inp)
    return retriever, serve._events(inp.columns(inp.request(0, 24))), rankers


def _recorded(cell, overlap=True):
    """The spans of one score_pass run inside recording()."""
    timing.reset_spans()
    with timing.recording():
        runner.score_pass(*cell, BATCH, overlap=overlap)
    assert timing.dropped() == 0
    return timing.spans()


def _covered(spans, parent, names):
    """The share of span `parent` that its children named `names` cover."""
    kids = [s for s in spans if s.parent == parent.id and s.name in names]
    assert all(parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns for s in kids)
    return sum(s.end_ns - s.start_ns for s in kids) / (parent.end_ns - parent.start_ns)


def test_nothing_recorded_when_off(cell):
    timing.reset_spans()
    runner.score_pass(*cell, BATCH)
    assert timing.span_totals() == {} and timing.spans() == []
    assert timing.span("otto::x") is timing.span("otto::y")     # the shared no-op


@pytest.mark.parametrize("overlap", [True, False])
def test_spans_cover_each_thread(cell, overlap):
    spans = _recorded(cell, overlap)
    by_name = defaultdict(list)
    for s in spans:
        by_name[s.name].append(s)
    (root,) = by_name["otto::runner.score_pass"]
    assert root.parent is None and root.thread == threading.current_thread().name
    # without overlap the batches' consumers run on this thread too
    names = PRODUCER if overlap else PRODUCER | {"otto::runner.consume"}
    assert _covered(spans, root, names) >= 0.95
    n = len(by_name["otto::retrieval.batch"])
    assert n >= 2 and len(by_name["otto::rank.score"]) == len(by_name["otto::rank.pull"]) == n
    for b in by_name["otto::retrieval.batch"]:
        stages = {s.name for s in spans if s.parent == b.id}
        assert stages == {"otto::retrieval.lookup", "otto::retrieval.h2d", "otto::retrieval.keep",
                          *(f"otto::retrieval.stage_{c}" for c in "abcde")}
        assert all(s.batch == b.batch for s in spans if s.parent == b.id)
    if overlap:
        (cons,) = by_name["otto::runner.consumer"]
        assert cons.parent == root.id and cons.thread == "pipeline-consume"
        assert _covered(spans, cons, CONSUMER) >= 0.95
        assert {s.thread for s in by_name["otto::rank.pull"]} == {"pipeline-consume"}
    else:
        # the same names on one thread, without the hand-offs
        assert {s.thread for s in spans} == {root.thread}
        assert not {"otto::runner.consumer", "otto::runner.get_wait",
                    "otto::runner.put_wait"} & set(by_name)
    assert {s.batch for s in by_name["otto::rank.score"]} == \
        {s.batch for s in by_name["otto::retrieval.batch"]}


def test_spans_carry_their_request(cell):
    timing.reset_spans()
    with timing.recording():
        runner.score_pass(*cell, BATCH)
        runner.score_pass(*cell, BATCH)
    spans = timing.spans()
    roots = [s for s in spans if s.name == "otto::runner.score_pass"]
    assert len(roots) == 2 and roots[0].request != roots[1].request
    for r in roots:
        mine = [s for s in spans if r.start_ns <= s.start_ns and s.end_ns <= r.end_ns]
        assert len(mine) > 20 and {s.request for s in mine} == {r.request}
    ids = {s.id for s in spans}
    assert all(s.parent is None or s.parent in ids for s in spans)


def test_producer_spans_are_profiler_ranges(cell):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        with torch.profiler.record_function("warm-up"):   # a process's first range is late
            pass
    timing.reset_spans()
    with torch.profiler.profile(activities=acts) as prof:
        runner.score_pass(*cell, BATCH)
    events = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("otto::"):
            # no user annotation: the profiler would copy it onto a card's timeline
            assert e.activity_type() == "cpu_op", e.name()
            events[e.name()].append(e.start_ns())
    spans = timing.spans()
    producer = [s for s in spans if s.thread == threading.current_thread().name]
    assert len(producer) > 20
    # the consumer thread's spans are the registry's alone
    assert not {s.name for s in spans if s.thread != threading.current_thread().name} \
        & set(events)
    for name in {s.name for s in producer}:
        mine = sorted(s.start_ns for s in producer if s.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs), name
        assert max(abs(a - b) for a, b in zip(mine, theirs)) < 1_000_000, name


class _Failing:
    """A ranker whose scoring raises on the consumer thread."""

    def __init__(self, ranker):
        self.feature_names = ranker.feature_names

    def predict_scores_device(self, feats):
        raise RuntimeError("scoring failed")


def test_consumer_error_closes_every_span(cell):
    retriever, events, rankers = cell
    bad = dict(rankers, carts=_Failing(rankers["carts"]))
    timing.reset_spans()
    with timing.recording(), pytest.raises(RuntimeError, match="scoring failed"):
        runner.score_pass(retriever, events, bad, BATCH)
    assert timing.current_request() is None
    spans = timing.spans()
    ids = {s.id for s in spans}
    assert {"otto::runner.score_pass", "otto::runner.consumer"} <= {s.name for s in spans}
    assert all(s.parent is None or s.parent in ids for s in spans)
    n_score = sum(s.name == "otto::rank.score" for s in spans)
    assert n_score >= 1 and sum(s.name == "otto::runner.consume" for s in spans) == n_score
    # a later call starts from an empty stack
    _recorded(cell)


def _reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"span_reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_span_readers(cell):
    readers = {n: _reader(n) for n in READERS}
    _recorded(cell)
    summary = {"busy_s": 0.5, "window_s": 1.0, "sessions": 24}
    for name, r in readers.items():
        assert r.read({}) is None, name
        v = r.read(summary)
        assert v is not None and 0 <= v < float("inf"), name
        # a CPU run's summary has no device trace: nothing to read
        assert r.read({"window_s": 1.0, "sessions": 24}) is None, name
    assert readers["runner.consumer_wait_share"].read(summary) <= 100


def test_counters_under_thread_switches():
    c = timing.counter("otto::test.adds")
    c.reset()
    assert timing.counter("otto::test.adds") is c
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [c.add() for _ in range(2000)])
                   for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert c.value == 16 * 2000
