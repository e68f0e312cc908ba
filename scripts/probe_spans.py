"""The port's own serving spans (otto_tpu_torch/utils/timing.py) on the card.

    python3 scripts/probe_spans.py trace --workload gbdt-passb --seed 7 --out spans.json
    python3 scripts/probe_spans.py cost --seed 7 --pairs 5 --out cost.json

`trace` runs one benchmark cell traced, as `benchmark/run.py --trace 1`
does (its result line is printed the same way), keeps the `otto::` ranges
of the profiler's trace, and then reads the program's span registry over
the traced slice: for each request the share of `otto::runner.score_pass`
that the producer's child spans cover and the share of the consumer's
`otto::runner.consumer` that its child spans cover, and how far each
producer span's start lies from the start of its profiler range
(registry minus profiler, ns); and the device's idle gaps by the
innermost producer span open at each gap's middle, found by interval,
for every gap and for those that the benchmark's probe, looking back a
fixed 400 host events, leaves under "host: no operator open".

`cost` times `score_pass` on the `otto-gbdt` configuration with
`timing.recording()` on and off, in alternating pairs: one 65,536-session
request (the `passb` shape), then 200 requests of 256 sessions (the
`nearline` shape), then `--interleaved` 256-session requests each run
once on and once off in turn (the median paired difference). The
profiler stays off, so the spans record into the registry alone.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PRODUCER = ("otto::retrieval.pack", "otto::retrieval.batch", "otto::runner.put_wait",
            "otto::runner.join", "otto::runner.assemble")
CONSUMER = ("otto::runner.get_wait", "otto::runner.consume")


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def coverage(spans, root_name, names):
    """(per span named root_name the share of it that its children named
    `names` cover, the share over all of them)."""
    kids = defaultdict(int)
    for s in spans:
        if s.name in names:
            kids[s.parent] += s.end_ns - s.start_ns
    roots = [(kids[r.id], r.end_ns - r.start_ns) for r in spans if r.name == root_name]
    total = sum(d for _, d in roots)
    return [k / d for k, d in roots], (sum(k for k, _ in roots) / total if total else None)


def clock_offsets(spans, ranges, thread):
    """Registry start minus profiler start (ns) of each span of `thread`,
    paired with the profiler's ranges of its name in start order."""
    mine, out = defaultdict(list), []
    for s in spans:
        if s.thread == thread:
            mine[s.name].append(s.start_ns)
    for name, starts in mine.items():
        theirs = sorted(ranges.get(name, []))
        if len(theirs) == len(starts):
            out += [a - b for a, b in zip(sorted(starts), theirs)]
    return out


def device_busy(events):
    """The device's merged busy intervals, as benchmark/tracing.py's
    summarize() takes them."""
    import torch

    from benchmark import tracing

    iv = []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0 \
                and not e.name().startswith(("bench::", "otto::")) \
                and tracing._kind(e) != "gpu_user_annotation" and tracing.MARK not in e.name():
            iv.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return tracing._merge(iv)


def gaps_by_span(busy, host_ops, spans, thread):
    """The device's idle gaps by the innermost span of `thread` open at the
    gap's middle, found by interval: ({span: seconds} of every gap, {span:
    seconds} of the gaps that the probe's look-back of 400 host events puts
    under "host: no operator open")."""
    ops = sorted(o for o in host_ops if o[1] > o[0])
    starts = [o[0] for o in ops]
    mine = sorted((s for s in spans if s.thread == thread), key=lambda s: s.start_ns)
    by_id = {s.id: s for s in mine}
    span_starts = [s.start_ns for s in mine]
    every, no_op = defaultdict(float), defaultdict(float)
    for (_, e0), (s1, _) in zip(busy[:-1], busy[1:]):
        gap, mid = (s1 - e0) * 1e-9, (e0 + s1) // 2
        k = bisect.bisect_right(span_starts, mid) - 1
        sp = mine[k] if k >= 0 else None
        while sp is not None and sp.end_ns < mid:
            sp = by_id.get(sp.parent)
        label = sp.name if sp is not None else "outside any request"
        every[label] += gap
        i = bisect.bisect_right(starts, mid) - 1
        if not any(ops[j][1] >= mid for j in range(i, max(-1, i - 400), -1)):
            no_op[label] += gap
    top = (lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1])[:12]))
    return top(every), top(no_op)


def trace(args) -> dict:
    import threading

    import torch

    from benchmark import run, tracing
    from otto_tpu_torch.utils import timing

    ranges, on_device = defaultdict(list), defaultdict(int)
    kept = {}
    summarize = tracing.summarize

    def keep_ranges(prof, window_s):
        events = prof.profiler.kineto_results.events()
        host = []
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if e.name().startswith("otto::"):
                    on_device[e.name()] += 1     # a copy on the device's timeline
                continue
            host.append((e.start_ns(), e.start_ns() + e.duration_ns()))
            if e.name().startswith("otto::"):
                ranges[e.name()].append(e.start_ns())
        kept["busy"], kept["host"] = device_busy(events), host
        return summarize(prof, window_s)

    tracing.summarize = keep_ranges
    try:
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", "1"])
    finally:
        tracing.summarize = summarize
    spans = timing.spans()
    prod, prod_all = coverage(spans, "otto::runner.score_pass", PRODUCER)
    cons, cons_all = coverage(spans, "otto::runner.consumer", CONSUMER)
    me = threading.current_thread().name
    off = clock_offsets(spans, ranges, me)
    every, no_op = gaps_by_span(kept.get("busy", []), kept.get("host", []), spans, me)
    return {
        "rc": rc, "card": card(), "workload": args.workload, "seed": args.seed,
        "requests": len(prod), "producer_cover": prod_all, "consumer_cover": cons_all,
        "producer_cover_min": min(prod, default=None),
        "consumer_cover_min": min(cons, default=None),
        "clock_offset_ns_median": statistics.median(off) if off else None,
        "clock_offset_ns_abs_max": max(map(abs, off)) if off else None,
        "clock_pairs": len(off), "dropped": timing.dropped(),
        "totals": timing.span_totals(),
        "profiler_ranges": {k: len(v) for k, v in ranges.items()},
        "device_copies": dict(on_device),
        "gaps_by_span_s": every, "no_operator_gaps_by_span_s": no_op,
    }


def cost(args) -> dict:
    import torch

    from benchmark import harness, serve
    from otto_tpu_torch.pipeline import runner
    from otto_tpu_torch.utils import timing

    spec = harness.load_spec()
    _, cfg, _ = harness.find_cell(spec, "gbdt-passb")
    inp = serve.Inputs(cfg, args.seed, torch.device("cuda"))
    retriever, rankers = serve._port(cfg, inp)
    batch = cfg["batch_sessions"]
    N = inp.stream.n_sessions

    def call(first, n, lat=None):
        ev = serve._events(inp.columns(inp.request(first % N, n)))
        t = time.perf_counter()
        runner.score_pass(retriever, ev, rankers, batch)
        dt = time.perf_counter() - t
        if lat is not None:
            lat.append(dt)
        return dt

    def timed(on, fn):
        if not on:
            return fn()
        with timing.recording():
            return fn()

    call(0, 65536)
    for i in range(8):
        call(i * 256, 256)
    out = {"card": card(), "seed": args.seed, "passb_s": {"on": [], "off": []},
           "nearline_s": {"on": [], "off": []}}
    lat = {True: [], False: []}
    first = 0
    for p in range(args.pairs):
        for on in ((True, False) if p % 2 == 0 else (False, True)):
            out["passb_s"]["on" if on else "off"].append(
                timed(on, lambda: call(first, 65536)))
            first += 65536
            timing.reset_spans()
    for p in range(args.pairs):
        for on in ((True, False) if p % 2 == 0 else (False, True)):
            def requests():
                return sum(call(first + i * 256, 256, lat[on]) for i in range(200))
            out["nearline_s"]["on" if on else "off"].append(timed(on, requests))
            first += 200 * 256
            timing.reset_spans()
    for k in ("passb_s", "nearline_s"):
        on, off = (statistics.median(out[k][s]) for s in ("on", "off"))
        out[k + "_cost_pct"] = 100.0 * (on - off) / off
    on, off = (statistics.median(lat[s]) for s in (True, False))
    out["nearline_request_median_ms"] = {"on": 1e3 * on, "off": 1e3 * off}
    out["nearline_request_cost_pct"] = 100.0 * (on - off) / off
    # the same requests with recording on and off one after the other, the
    # order alternating, so that the host's drift falls on both sides
    diff = []
    for p in range(args.interleaved):
        t = {}
        for on in ((True, False) if p % 2 == 0 else (False, True)):
            t[on] = timed(on, lambda: call(first, 256))
        diff.append(t[True] - t[False])
        first += 256
        timing.reset_spans()
    if diff:
        out["nearline_paired_diff_ms_median"] = 1e3 * statistics.median(diff)
        out["nearline_paired_diff_ms_quartiles"] = [
            1e3 * q for q in statistics.quantiles(diff, n=4)]
        out["nearline_paired_cost_pct"] = 100.0 * statistics.median(diff) / off
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="what", required=True)
    t = sub.add_parser("trace")
    t.add_argument("--workload", required=True)
    t.add_argument("--seconds", type=float, default=51)
    c = sub.add_parser("cost")
    c.add_argument("--pairs", type=int, default=5)
    c.add_argument("--interleaved", type=int, default=500,
                   help="near-line requests run twice, on and off in turn")
    for p in (t, c):
        p.add_argument("--seed", type=int, required=True)
        p.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = trace(args) if args.what == "trace" else cost(args)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print("SPANS " + json.dumps({k: v for k, v in out.items() if k != "totals"}))
    return int(out.get("rc", 0))


if __name__ == "__main__":
    sys.exit(main())
