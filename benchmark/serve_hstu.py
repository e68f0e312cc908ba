"""The HSTU serving cell: one closed-loop client over `score_pass` with the
HSTU multi-task ranker (otto_tpu_torch/models/hstu.py).

As benchmark/serve.py, whose `Inputs`, `judge` and `_sample` it reuses:
set-up draws every input from the seed on the card (the session stream,
the retrieval tables and session lookup as serve.py draws them, and the
ranker's weights: `hstu_weights`), builds the port's Retriever and one
HSTURanker serving the three targets, and serves `warmup_requests`
requests. The window issues requests back to back for `seconds`, each one
`score_pass` over the next `sessions_per_request` sessions, timed from
its issue to its three top-k lists on the host. After the window every
request's lists are held complete, and the sample of served sessions that
serve.py draws is scored again by the plain reference (the frozen
retrieval, then benchmark/reference/hstu.py on each session's events) and
compared list by list.

The traced run's probe (`HSTUProbe`) is serve.py's, with the HSTU model's
work in place of the feature-only rankers': `rank_ops` counts the model's
FLOPs from each batch's history lengths and valid candidates (driver-side,
benchmark/hstu_work.py), `rank_peak` is the card's dense bfloat16 peak,
and kernel K6's calls are recorded by shape for its roofline.
"""
from __future__ import annotations

import gc
import statistics
import sys
import time
import traceback
from typing import List

import numpy as np
import torch

from benchmark import hstu_work, serve, tracing
from benchmark.reference import check
from benchmark.reference import hstu as ref_hstu
from benchmark.reference.retrieval import FEATURE_NAMES as REF_FEATURES
from otto_tpu_torch.models import hstu as port_hstu

TYPES = ("clicks", "carts", "orders")
K6_NAME = "hstu_attention_kernel"


def hstu_weights(cfg: dict, n_features: int, seed: int, device) -> dict:
    """The ranker's float32 parameters, drawn on `device` by one
    torch.Generator: item rows N(0, 1), type rows N(0, 0.25), the feature
    projection, W1, W2 and the heads N(0, 1 / fan-in) (outputs near unit
    variance), b1 N(0, 0.01), b2 N(0, 0.0025), position and time biases
    N(0, 0.25), head biases 0; normalisation statistics in the range of the
    log-squashed features (mean U(-1, 5), std U(0.5, 3), as
    gen/rankers.py draws the MLP's)."""
    h = cfg["hstu"]
    d, H = h["d_model"], h["n_heads"]
    width = 2 * H * h["d_v"] + 2 * H * h["d_qk"]
    g = torch.Generator(device=torch.device(device)).manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=g.device) * std

    p = {"item_emb": normal((cfg["n_aids"], d), 1.0),
         "type_emb": normal((3, d), 0.5),
         "feat_proj": normal((n_features, d), n_features ** -0.5),
         "norm_mean": torch.rand((n_features,), generator=g, device=g.device) * 6.0 - 1.0,
         "norm_std": torch.rand((n_features,), generator=g, device=g.device) * 2.5 + 0.5}
    for i in range(h["n_blocks"]):
        p[f"w1_{i}"] = normal((d, width), d ** -0.5)
        p[f"b1_{i}"] = normal((width,), 0.1)
        p[f"w_pos_{i}"] = normal((h["max_seq_len"] + 1,), 0.5)
        p[f"w_time_{i}"] = normal((h["n_time_buckets"] + 1,), 0.5)
        p[f"w2_{i}"] = normal((H * h["d_v"], d), (H * h["d_v"]) ** -0.5)
        p[f"b2_{i}"] = normal((d,), 0.05)
    p["head_w"] = normal((d, len(TYPES)), d ** -0.5)
    p["head_b"] = torch.zeros((len(TYPES),), device=g.device)
    return p


class HSTUInputs(serve.Inputs):
    """serve.Inputs without its feature-only rankers, with the HSTU
    ranker's weights from the same sub-seed."""

    def __init__(self, cfg: dict, seed: int, device):
        super().__init__(dict(cfg, ranker_backend="gbdt", ranker={"n_rankers": 0}), seed,
                         device)
        self.weights = hstu_weights(cfg, len(REF_FEATURES), serve.sub_seeds(seed, 4)[3],
                                    device)


def _port(cfg: dict, inp: HSTUInputs):
    """The port's Retriever and its three targets' ranker: one HSTURanker."""
    from otto_tpu_torch.config import HSTUConfig
    from otto_tpu_torch.engine.retrieval import FEATURE_NAMES

    retriever, _ = serve._port(cfg, inp)     # inp.rankers is empty: no ranker built
    ranker = port_hstu.HSTURanker(HSTUConfig(**cfg["hstu"]), inp.weights,
                                  tuple(FEATURE_NAMES))
    return retriever, {t: ranker for t in TYPES}


class HSTUProbe(tracing.Probe):
    """serve.py's probe, counting the HSTU model's work: per batch the
    valid tokens, open query-key pairs and candidates (from the batch's
    history lengths, capped at max_seq_len, and valid candidates, summed
    on the card), and per K6 call its jagged shape."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        self.work = None          # [tokens, pairs, candidates] on the card
        self.k6_flops = None
        self.k6_bytes = 0
        self.k6_calls = 0

    def _install(self):
        super()._install()
        from otto_tpu_torch.engine import rank

        h = self.cfg["hstu"]

        def counted_hstu(fn):
            def call(b, *a, **kw):
                aid, _, _ = b.history_device()
                L = (aid >= 0).sum(1).clamp(max=h["max_seq_len"]).long()
                C = (b.cand_device() >= 0).sum(1).long()
                w = torch.stack([(L + C).sum(), (L * (L + 1) // 2 + C * (L + 1)).sum(),
                                 C.sum()])
                with self._lock:
                    self.work = w if self.work is None else self.work + w
                return fn(b, *a, **kw)
            return call

        def k6(fn):
            def call(q, k, v, offsets, n_hist, ts, w_pos, w_time, thr, n_scale, *a, **kw):
                out = fn(q, k, v, offsets, n_hist, ts, w_pos, w_time, thr, n_scale, *a, **kw)
                if q.device.type == "cuda":
                    N, H, dqk = q.shape
                    dv = v.shape[2]
                    S = n_hist.shape[0]
                    L = n_hist.long()
                    C = (offsets[1:] - offsets[:-1]).long() - L
                    pairs = (L * (L + 1) // 2 + C * (L + 1)).sum()
                    with self._lock:
                        f = hstu_work.k6_flops(pairs, H, dqk, dv)
                        self.k6_flops = f if self.k6_flops is None else self.k6_flops + f
                        self.k6_bytes += hstu_work.k6_bytes(N, S, H, dqk, dv, w_pos.shape[0],
                                                            w_time.shape[0])
                        self.k6_calls += 1
                return out
            return call

        self._patch(rank, "score_topk_multi", counted_hstu)
        self._patch(port_hstu, "hstu_attention", k6)

    def stop(self, sessions: int):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self._uninstall()
        self.active = False
        rows = int(self.rows) if self.rows is not None else 0
        tokens, pairs, cands = (self.work.tolist() if self.work is not None else (0, 0, 0))
        self.summary = tracing.summarize(self.prof, window_s)
        self.summary.update({
            "sessions": sessions, "rows": rows,
            "rank_ops": hstu_work.model_flops(tokens, pairs, cands, self.cfg["hstu"],
                                              len(REF_FEATURES), len(TYPES)),
            "rank_peak": hstu_work.BF16_DENSE_FLOPS, "runner": dict(self.runner),
            "k1_bytes": self.k1_bytes, "k1_calls": self.k1_calls,
            "k2_bytes": self.k2_bytes, "k2_calls": self.k2_calls,
            "hstu_tokens": tokens, "hstu_pairs": pairs,
            "k6_s": device_seconds(self.prof, K6_NAME),
            "k6_flops": float(self.k6_flops) if self.k6_flops is not None else 0.0,
            "k6_bytes": self.k6_bytes, "k6_calls": self.k6_calls,
        })
        self.prof = None


def device_seconds(prof, name: str) -> float:
    """Seconds of the device's operations whose name holds `name`."""
    total = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and name in e.name():
            total += e.duration_ns()
    return total * 1e-9


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of the HSTU serving cell -> the driver's part of the result
    line (serve.run's keys)."""
    from otto_tpu_torch.pipeline import runner

    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    inp = HSTUInputs(cfg, seed, dev)
    retriever, rankers = _port(cfg, inp)
    R = traffic["sessions_per_request"]
    batch = cfg["batch_sessions"]

    def serve_one(first):
        ids = inp.request(first, R)
        preds = runner.score_pass(retriever, serve._events(inp.columns(ids)), rankers, batch)
        return ids, preds

    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    N = inp.stream.n_sessions
    for w in range(traffic["warmup_requests"]):
        serve_one((N - (w + 1) * R) % N)
    if on_cuda:
        torch.cuda.synchronize()
    t_win = time.perf_counter()
    setup_s = t_win - t_start

    probe = HSTUProbe(cfg) if trace else None
    lat: List[float] = []
    done: List[tuple] = []
    attempted = failed = 0
    t_last = t_win
    i = 0
    trace_end = traffic["trace_skip_requests"] + traffic["trace_requests"]
    while time.perf_counter() - t_win < seconds or (probe is not None and i < trace_end):
        if probe is not None and i == traffic["trace_skip_requests"]:
            probe.start()
        t0 = time.perf_counter()
        attempted += 1
        try:
            ids, preds = serve_one((i * R) % N)
        except Exception:  # a failed request counts as missing
            traceback.print_exc(file=sys.stderr)
            failed += 1
            lat.append(float("inf"))
            i += 1
            continue
        t_last = time.perf_counter()
        lat.append(t_last - t0)
        done.append((ids, preds))
        i += 1
        if probe is not None and probe.active and i == trace_end:
            probe.stop(sessions=R * traffic["trace_requests"])
    if probe is not None and probe.active:
        probe.stop(sessions=R * (i - traffic["trace_skip_requests"]))
    window_s = t_last - t_win
    peak = torch.cuda.max_memory_allocated(dev) if on_cuda else 0

    missing = 0
    for ids, preds in done:
        want = np.sort(ids)
        for t in TYPES:
            s, a = preds[t]
            if not (np.array_equal(s, want) and a.shape == (len(want), cfg["top_k"])):
                missing += len(np.setxor1d(want, s)) or len(want)
    completed = sum(len(ids) for ids, _ in done)

    served = serve._sample(done, inp, traffic, seed, cfg["top_k"])
    del retriever, rankers, done
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    ref = reference(cfg, inp, sorted(served), ("full",))
    g = check.list_gaps(served, ref, cfg["top_k"])
    checks, correct = serve.judge(cfg["correct"], g, missing)
    correct = correct and failed == 0
    finite = [x for x in lat if np.isfinite(x)]
    e2e = {"setup_s": setup_s}
    if window_s > 0:
        e2e["sessions_per_s"] = completed / window_s
    if lat:
        e2e["request_p90_ms"] = 1e3 * float(np.percentile(lat, 90))
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "end_to_end": e2e, "memory_peak_bytes": int(peak), "checks": checks,
           "info": {"requests": len(lat), "sessions": completed, "window_s": window_s,
                    "latency_median_ms": 1e3 * statistics.median(finite) if finite else None,
                    "candidates_mean": serve._cand_mean(ref), "setup_s": setup_s}}
    if probe is not None:
        out["summary"] = probe.summary
    return out


def reference(cfg: dict, inp: HSTUInputs, sessions, precisions):
    """{session: RefSession} of the plain reference over `sessions`."""
    ids = np.asarray(sessions, np.int64)
    cl = {int(s): int(inp.sessions.cluster[s]) for s in ids}
    em = {int(s): inp.sessions.emb[s] for s in ids}
    with torch.no_grad():
        return ref_hstu.reference_scores(inp.columns(ids), cl, em, inp.ctx, cfg["retrieval"],
                                         inp.weights, cfg["hstu"], cfg["batch_sessions"],
                                         precisions)
