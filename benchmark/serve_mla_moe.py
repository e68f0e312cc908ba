"""The MLA + MoE serving cell: one closed-loop client over `score_pass` with
the MLA + MoE multi-task ranker (otto_tpu_torch/models/mla_moe.py).

As benchmark/serve_hstu.py, whose `device_seconds` it reuses, and
benchmark/serve.py, whose `Inputs`, `judge` and `_sample` it reuses:
set-up draws every input from the seed on the card (the session stream,
the retrieval tables and session lookup as serve.py draws them, and the
ranker's weights: `mla_moe_weights`), builds the port's Retriever and one
MLAMoERanker serving the three targets, and serves `warmup_requests`
requests. The window issues requests back to back for `seconds`. After
the window every request's lists are held complete, and the expert sets
the program chose for every token it served are recorded (`ServedRouting`:
a near-tied choice may go either way between two batches of other
shapes, so the sets must be those the served lists came from). The
sample of served sessions that serve.py draws is retrieved again by the
frozen retrieval and, once the program's objects are freed, scored by the
plain reference (benchmark/reference/mla_moe.py) one layer at a time, on
the program's served expert sets. The lists are compared as serve.py compares them. The sets
are judged apart, by the reference's own router scores: `route_margin`
is the farthest any of them lies from the reference's top-k (0 where it
is the top-k: only near-ties may differ), `routing_flip_share` the share
of (token, MoE layer) sets that are not the reference's top-k.

The configuration's model keys are MLAMoEConfig's, at the file's top level
(a DeepSeek-V3 config.json's names). The traced run's probe
(`MLAMoEProbe`) is serve.py's with the ranker's work in place of the
feature-only rankers': `rank_ops` counts its product FLOPs from each
batch's history lengths and valid candidates (benchmark/mla_moe_work.py),
`rank_peak` is the card's dense bfloat16 peak, and kernel K9's and K6's
softmax form's calls are recorded by shape for their rooflines.
"""
from __future__ import annotations

import dataclasses
import gc
import statistics
import sys
import threading
import time
import traceback
import types
from typing import List

import numpy as np
import torch

from benchmark import mla_moe_work, serve, tracing
from benchmark.reference import check
from benchmark.reference import mla_moe as ref_mla
from benchmark.reference.retrieval import FEATURE_NAMES as REF_FEATURES
from benchmark.serve_hstu import device_seconds
from otto_tpu_torch.config import MLAMoEConfig
from otto_tpu_torch.models import mla_moe as port_mla

F32 = torch.float32
TYPES = ("clicks", "carts", "orders")
K9_NAME = "grouped_gemm_kernel"
K6S_NAME = "softmax_attention_kernel"
# the sublayers' output scales (the gains of their output projections'
# N(0, gain^2 / fan-in) draws): attention's, and the MLPs' down
# projections', dense, shared and routed alike
ATTN_OUT = 0.7
FFN_OUT = 0.6
# rows of the item table drawn at a time (bounds set-up's float32 draw)
DRAW_ROWS = 1 << 18


def model_keys(cfg: dict) -> dict:
    """The configuration's model keys, as MLAMoEConfig names them."""
    return {f.name: cfg[f.name] for f in dataclasses.fields(MLAMoEConfig)}


def model_config(cfg: dict) -> MLAMoEConfig:
    return MLAMoEConfig(**model_keys(cfg))


def mla_moe_weights(m: dict, n_aids: int, n_features: int, seed: int, device) -> dict:
    """The ranker's parameters (models/mla_moe.py::param_shapes' names; the
    product weights in bfloat16, the rest float32), drawn on `device` by
    one torch.Generator in param_shapes' order: item rows N(0, 1), type
    rows N(0, 0.25); every projection N(0, 1 / fan-in), so that q, k, v,
    the latent and the experts' gate and up stay near unit variance, but
    the attention output (ATTN_OUT^2 / fan-in) and every MLP's down
    projection (FFN_OUT^2 / fan-in: dense, routed, and shared, whose
    slices' fan-in is the shared MLP's whole width), which keep each
    sublayer's output below a unit residual over the depth, so that a
    session's candidate scores spread;
    RMSNorm gains 1 + N(0, 0.1^2); the router N(0, 1 / d) and its
    correction bias N(0, 0.03^2); head biases 0; normalisation statistics
    in the range of the log-squashed features (mean U(-1, 5), std
    U(0.5, 3), as serve_hstu.py draws them)."""
    cfg = MLAMoEConfig(**m)
    g = torch.Generator(device=torch.device(device)).manual_seed(seed)
    Ie = cfg.moe_intermediate_size
    E = cfg.n_routed_experts

    def normal(shape, std, dtype):
        out = torch.empty(shape, dtype=dtype, device=g.device)
        for a in range(0, shape[0], DRAW_ROWS):
            b = min(shape[0], a + DRAW_ROWS)
            out[a:b] = torch.randn((b - a,) + tuple(shape[1:]), generator=g,
                                   device=g.device) * std
        return out

    p = {}
    for name, shape in port_mla.param_shapes(cfg, n_aids, n_features).items():
        base = port_mla._base(name)
        dt = port_mla.param_dtype(name)
        if base == "norm_mean":
            p[name] = torch.rand(shape, generator=g, device=g.device) * 6.0 - 1.0
        elif base == "norm_std":
            p[name] = torch.rand(shape, generator=g, device=g.device) * 2.5 + 0.5
        elif base.endswith("norm"):
            p[name] = 1.0 + normal(shape, 0.1, dt)
        elif base == "head_b":
            p[name] = torch.zeros(shape, device=g.device)
        elif base == "moe_w2":
            std = torch.full((shape[0], 1, 1), FFN_OUT * Ie ** -0.5, device=g.device)
            std[E:] = FFN_OUT * (Ie * cfg.n_shared_experts) ** -0.5
            p[name] = (normal(shape, 1.0, F32) * std).to(dt)
        else:
            fixed = {"item_emb": 1.0, "type_emb": 0.5, "router_bias": 0.03}
            fan_in = shape[-1] if base == "moe_w13" else shape[0]
            gain = {"wo": ATTN_OUT, "mlp_w2": FFN_OUT}.get(base, 1.0)
            std = fixed[base] if base in fixed else gain * fan_in ** -0.5
            p[name] = normal(shape, std, dt)
    return p


class MLAMoEInputs(serve.Inputs):
    """serve.Inputs without its feature-only rankers, with the MLA + MoE
    ranker's weights from the same sub-seed."""

    def __init__(self, cfg: dict, seed: int, device):
        super().__init__(dict(cfg, ranker_backend="gbdt", ranker={"n_rankers": 0}), seed,
                         device)
        self.weights = mla_moe_weights(model_keys(cfg), cfg["n_aids"], len(REF_FEATURES),
                                       serve.sub_seeds(seed, 4)[3], device)


def _port(cfg: dict, inp: MLAMoEInputs):
    """The port's Retriever and its three targets' ranker: one MLAMoERanker
    over the inputs' weights (not copied)."""
    from otto_tpu_torch.engine.retrieval import FEATURE_NAMES

    retriever, _ = serve._port(cfg, inp)     # inp.rankers is empty: no ranker built
    ranker = port_mla.MLAMoERanker(model_config(cfg), inp.weights, tuple(FEATURE_NAMES))
    return retriever, {t: ranker for t in TYPES}


class MLAMoEProbe(tracing.Probe):
    """serve.py's probe, counting the ranker's work: per batch the valid
    tokens, open query-key pairs and candidates (from the batch's history
    lengths, capped at max_seq_len, and valid candidates, summed on the
    card), and per K9 or K6 softmax call its shape."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        self.work = None          # [tokens, pairs, candidates] on the card
        self.k9_flops = 0
        self.k9_bytes = 0
        self.k9_calls = 0
        self.k6s_flops = None
        self.k6s_bytes = 0
        self.k6s_calls = 0

    def _install(self):
        super()._install()
        from otto_tpu_torch.engine import rank

        m = model_keys(self.cfg)

        def counted(fn):
            def call(b, *a, **kw):
                aid, _, _ = b.history_device()
                L = (aid >= 0).sum(1).clamp(max=m["max_seq_len"]).long()
                C = (b.cand_device() >= 0).sum(1).long()
                w = torch.stack([(L + C).sum(), (L * (L + 1) // 2 + C * (L + 1)).sum(),
                                 C.sum()])
                with self._lock:
                    self.work = w if self.work is None else self.work + w
                return fn(b, *a, **kw)
            return call

        def k9(fn):
            def call(a, w, offsets, rows=None, gate_up=False, *rest, **kw):
                out = fn(a, w, offsets, rows, gate_up, *rest, **kw)
                if a.device.type == "cuda":
                    E, N_w, K = w.shape
                    R = rows.shape[0] if rows is not None else a.shape[0]
                    with self._lock:
                        self.k9_flops += mla_moe_work.k9_flops(R, N_w, K)
                        self.k9_bytes += mla_moe_work.k9_bytes(R, E, N_w, K, gate_up)
                        self.k9_calls += 1
                return out
            return call

        def k6s(fn):
            def call(q, k, v, offsets, n_hist, scale, *a, **kw):
                out = fn(q, k, v, offsets, n_hist, scale, *a, **kw)
                if q.device.type == "cuda":
                    N, H, dqk = q.shape
                    L = n_hist.long()
                    C = (offsets[1:] - offsets[:-1]).long() - L
                    pairs = (L * (L + 1) // 2 + C * (L + 1)).sum()
                    f = mla_moe_work.softmax_flops(pairs, H, dqk, v.shape[2])
                    with self._lock:
                        self.k6s_flops = f if self.k6s_flops is None else self.k6s_flops + f
                        self.k6s_bytes += mla_moe_work.softmax_bytes(
                            N, n_hist.shape[0], H, dqk, v.shape[2])
                        self.k6s_calls += 1
                return out
            return call

        self._patch(rank, "score_topk_multi", counted)
        self._patch(port_mla, "grouped_gemm", k9)
        self._patch(port_mla, "softmax_attention", k6s)

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
            "rank_ops": mla_moe_work.model_flops(tokens, pairs, cands, model_keys(self.cfg),
                                                 len(REF_FEATURES), len(TYPES)),
            "rank_peak": mla_moe_work.BF16_DENSE_FLOPS, "runner": dict(self.runner),
            "k1_bytes": self.k1_bytes, "k1_calls": self.k1_calls,
            "k2_bytes": self.k2_bytes, "k2_calls": self.k2_calls,
            "mla_moe_tokens": tokens, "mla_moe_pairs": pairs,
            "k9_s": device_seconds(self.prof, K9_NAME), "k9_flops": float(self.k9_flops),
            "k9_bytes": self.k9_bytes, "k9_calls": self.k9_calls,
            "k6s_s": device_seconds(self.prof, K6S_NAME),
            "k6s_flops": float(self.k6s_flops) if self.k6s_flops is not None else 0.0,
            "k6s_bytes": self.k6s_bytes, "k6s_calls": self.k6s_calls,
        })
        self.prof = None


def encode_sample(cfg: dict, sample, ranker, route=None):
    """The program's encoder over the sample's batches, with `route` (the
    program's router, or a stand-in of its signature) recording. -> (its
    expert sets, one [tokens, k] tensor a MoE layer in the sample's token
    order, {session: [3, top_k] aids} its lists)."""
    from otto_tpu_torch.engine import rank

    log: List[torch.Tensor] = []
    orig = port_mla.route
    inner = route or orig

    def recording(*a, **kw):
        idx, w = inner(*a, **kw)
        log.append(idx)
        return idx, w

    n_moe = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    per_batch, lists = [], {}
    port_mla.route = recording
    try:
        for b in sample:
            log.clear()
            with torch.no_grad():
                sc = ranker.encode(b.aid, b.ts, b.type, b.cand, b.feats)
            if log:
                per_batch.append(torch.cat(log).view(n_moe, -1, log[0].shape[1]))
            tops = torch.stack([rank._topk_program(sc[t], b.cand, cfg["top_k"])[1]
                                for t in range(len(TYPES))]).cpu().numpy()
            for i, s in enumerate(b.session):
                lists[int(s)] = tops[:, i]
    finally:
        port_mla.route = orig
    return (list(torch.cat(per_batch, 1)) if per_batch else []), lists


def check_sample(cfg: dict, inp: MLAMoEInputs, served: dict):
    """The served sample retrieved again by the frozen retrieval."""
    ids = np.asarray(sorted(served), np.int64)
    cl = {int(s): int(inp.sessions.cluster[s]) for s in ids}
    em = {int(s): inp.sessions.emb[s] for s in ids}
    with torch.no_grad():
        return ref_mla.sample_inputs(inp.columns(ids), cl, em, inp.ctx, cfg["retrieval"],
                                     cfg["batch_sessions"])


class ServedRouting:
    """While installed, the program's expert sets for every batch it scores
    (engine/rank.py::score_topk_multi and models/mla_moe.py::route wrapped,
    on the scoring thread): a batch's sets [MoE layers, tokens, k] stay on
    the card as bytes, with each of its sessions' first token row, kept
    history length and valid candidates (slot order: the pack's token
    order). `sets_for` gives them in a sample's token order."""

    def __init__(self, cfg: dict):
        self.max_len = cfg["max_seq_len"]
        self.n_moe = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
        self.sets: List[torch.Tensor] = []
        self.where: dict = {}     # session -> (batch, first token row, L, candidates)
        self._local = threading.local()
        self._saved = None

    def install(self):
        from otto_tpu_torch.engine import rank

        score, route = rank.score_topk_multi, port_mla.route

        def recording_route(*a, **kw):
            idx, w = route(*a, **kw)
            log = getattr(self._local, "log", None)
            if log is not None:
                log.append(idx.to(torch.uint8))
            return idx, w

        def recording_score(b, *a, **kw):
            self._local.log = []
            try:
                out = score(b, *a, **kw)
            finally:
                log, self._local.log = self._local.log, None
            self._keep(b, log)
            return out

        self._saved = (rank, score, route)
        rank.score_topk_multi, port_mla.route = recording_score, recording_route

    def uninstall(self):
        if self._saved is not None:
            rank, score, route = self._saved
            rank.score_topk_multi, port_mla.route = score, route
            self._saved = None

    def _keep(self, b, log):
        """After the batch's pull (the card has finished it)."""
        if not log:
            return
        aid, _, _ = b.history_device()
        cand = b.cand_device()
        L = (aid >= 0).sum(1).clamp(max=self.max_len).cpu().numpy()
        cand = cand.cpu().numpy()
        T = L + (cand >= 0).sum(1)
        first = np.concatenate([[0], np.cumsum(T)[:-1]])
        j = len(self.sets)
        self.sets.append(torch.cat(log).view(self.n_moe, int(T.sum()), -1))
        for i, s in enumerate(np.asarray(b.session)):
            if int(s) >= 0 and int(s) not in self.where:
                row = cand[i]
                self.where[int(s)] = (j, int(first[i]), int(L[i]), row[row >= 0])

    def sets_for(self, sample) -> List[torch.Tensor]:
        """One [tokens, k] int64 tensor a MoE layer over the sample's tokens
        (reference/mla_moe.py::session_list's order: each session's kept
        history, then its candidates), the candidates matched by aid."""
        parts = []
        for b in sample:
            cand = b.cand.cpu().numpy()
            for i, s in enumerate(b.session):
                j, first, L, served = self.where[int(s)]
                ref_c = cand[i][cand[i] >= 0]
                at = {int(a): k for k, a in enumerate(served)}
                rows = np.concatenate([np.arange(L), L + np.asarray([at[int(a)] for a in ref_c],
                                                                    np.int64)])
                sets = self.sets[j][:, first + torch.from_numpy(rows).to(self.sets[j].device)]
                parts.append(sets)
        if not parts:
            return []
        return list(torch.cat(parts, 1).long())


def route_checks(limits: dict, routing) -> tuple:
    """(checks, within limits) of a Routing: its largest margin and its
    flip share, each beside its limit (null: printed, not compared)."""
    values = {"route_margin": routing.max_margin(),
              "routing_flip_share": routing.flip_share()}
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in values.items()}
    ok = all(c["limit"] is None or (c["value"] is not None and c["value"] <= c["limit"])
             for c in checks.values())
    return checks, ok


def allocator_info(dev) -> dict:
    """The caching allocator's reserved peak, its retries (a retry frees
    every cached block and allocates again: a stall) and its device
    allocations."""
    if torch.device(dev).type != "cuda":
        return {}
    st = torch.cuda.memory_stats(dev)
    return {"reserved_peak_bytes": int(st.get("reserved_bytes.all.peak", 0)),
            "alloc_retries": int(st.get("num_alloc_retries", 0)),
            "device_allocs": int(st.get("num_device_alloc", 0))}


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of the MLA + MoE serving cell -> the driver's part of the
    result line (serve.run's keys)."""
    from otto_tpu_torch.pipeline import runner

    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    inp = MLAMoEInputs(cfg, seed, dev)
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
    alloc_start = allocator_info(dev)
    recorder = ServedRouting(cfg)
    recorder.install()

    probe = MLAMoEProbe(cfg) if trace else None
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
    recorder.uninstall()
    window_s = t_last - t_win
    peak = torch.cuda.max_memory_allocated(dev) if on_cuda else 0
    alloc = allocator_info(dev)
    if alloc:
        alloc["window_alloc_retries"] = alloc["alloc_retries"] - alloc_start["alloc_retries"]

    missing = 0
    for ids, preds in done:
        want = np.sort(ids)
        for t in TYPES:
            s, a = preds[t]
            if not (np.array_equal(s, want) and a.shape == (len(want), cfg["top_k"])):
                missing += len(np.setxor1d(want, s)) or len(want)
    completed = sum(len(ids) for ids, _ in done)

    served = serve._sample(done, inp, traffic, seed, cfg["top_k"])
    sample = check_sample(cfg, inp, served)
    routes = recorder.sets_for(sample)
    del retriever, rankers, done, recorder
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    ref, routing = reference(cfg, inp, sample, [("full", "full", routes)])
    g = check.list_gaps(served, ref, cfg["top_k"])
    checks, correct = serve.judge(cfg["correct"], g, missing)
    r_checks, r_ok = route_checks(cfg["correct"], routing["full"])
    checks.update(r_checks)
    correct = correct and r_ok and failed == 0
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
                    "request_ms": [1e3 * x for x in finite],
                    "candidates_mean": serve._cand_mean(ref), "setup_s": setup_s, **alloc}}
    if probe is not None:
        out["summary"] = probe.summary
    return out


def reference(cfg: dict, inp: MLAMoEInputs, sample, streams):
    """({session: RefSession} of the plain reference over the sample,
    {stream: Routing}); `streams` as reference/mla_moe.py::forward takes
    them."""
    routing: dict = {}
    with torch.no_grad():
        ref = ref_mla.reference_scores(sample, inp.weights,
                                       types.SimpleNamespace(**model_keys(cfg)), streams,
                                       routing=routing)
    return ref, routing
