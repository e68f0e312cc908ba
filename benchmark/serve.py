"""The serving cells: one closed-loop client over `score_pass`.

Set-up draws every input from the seed on the card (gen/): the test
session stream, the retrieval tables, the session lookup and the rankers,
builds the port's Retriever and rankers from them, and serves
`warmup_requests` requests. The window then issues requests back to back
for `seconds`: request i is one `otto_tpu_torch.pipeline.runner.score_pass`
over the next `sessions_per_request` sessions of the stream (replayed
from the start when it runs out), timed from its issue to its three
top-k lists on the host. After the window every request's lists are held
complete, and a sample of the served sessions, drawn from the seed and
holding the longest, is scored again by the plain reference
(benchmark/reference/) and compared list by list.
"""
from __future__ import annotations

import gc
import statistics
import sys
import time
import traceback
from typing import Dict, List

import numpy as np
import torch

from benchmark import tracing
from benchmark.gen import rankers as gen_rankers
from benchmark.gen import tables as gen_tables
from benchmark.gen.sessions import SyntheticSpec, session_stream
from benchmark.reference import check
from benchmark.reference.retrieval import FEATURE_NAMES as REF_FEATURES


def sub_seeds(seed: int, n: int) -> List[int]:
    """n independent 63-bit seeds from the run's seed (any whole number)."""
    state = np.random.SeedSequence(int(seed) % 2**64).generate_state(n, np.uint64)
    return [int(s) & (2**63 - 1) for s in state]


class Inputs:
    """Everything the benchmark draws from the seed, shared by the program
    and the reference."""

    def __init__(self, cfg: dict, seed: int, device):
        s = sub_seeds(seed, 4)
        ss = cfg["sessions"]
        # the sizes come from the configuration's shape_seed, the contents
        # from the run's seed
        spec = SyntheticSpec(n_sessions=cfg["test_sessions"], n_aids=cfg["n_aids"],
                             max_len=ss["max_len"], mean_len=ss["mean_len"],
                             cat_size=ss["cat_size"], zipf_a=ss["zipf_a"],
                             p_revisit=ss["p_revisit"], p_neighbor=ss["p_neighbor"],
                             p_cart=ss["p_cart"], p_order_after_cart=ss["p_order_after_cart"],
                             span_days=ss["span_days"], seed=s[0])
        self.stream = session_stream(spec, ss["shape_seed"], device)
        g = torch.Generator(device=torch.device(device)).manual_seed(s[2])
        self.ctx = gen_tables.retrieval_context(self.stream, cfg, g)
        self.sessions = gen_tables.session_tables(
            self.stream, self.ctx.aid_emb, cfg["tables"]["pop_clusters"], g)
        self.rankers = gen_rankers.ranker_arrays(cfg, len(REF_FEATURES), s[3], device)

    def request(self, first: int, n: int) -> np.ndarray:
        """Session ids of the request that starts at stream position first."""
        N = self.stream.n_sessions
        return (first + np.arange(n)) % N

    def columns(self, ids: np.ndarray):
        """(session, aid, ts, type) of the sessions `ids` (ascending runs of
        the stream), in the stream's (session, ts) order."""
        st = self.stream.starts
        ids = np.sort(ids)
        lens = st[ids + 1] - st[ids]
        rows = np.repeat(st[ids], lens) + (np.arange(lens.sum()) - np.repeat(
            np.cumsum(lens) - lens, lens))
        return (self.stream.session[rows], self.stream.aid[rows], self.stream.ts[rows],
                self.stream.type[rows])


def _port(cfg: dict, inp: Inputs):
    """The port's Retriever and rankers, made from the benchmark's inputs."""
    from otto_tpu_torch.config import GBDTConfig, RankerConfig, RetrievalConfig
    from otto_tpu_torch.engine.covis import CoVisTables
    from otto_tpu_torch.engine.retrieval import (
        FEATURE_NAMES, Retriever, RetrievalContext, SessionLookup)
    from otto_tpu_torch.models.gbdt import GBDTRanker
    from otto_tpu_torch.models.ranker import Ranker, RankerTower

    if tuple(FEATURE_NAMES) != tuple(REF_FEATURES):
        raise RuntimeError("the port's FEATURE_NAMES differ from the reference's")
    c = inp.ctx
    ctx = RetrievalContext(covis=tuple(CoVisTables(*t) for t in c.covis),
                           knn_all=tuple(c.knn_all), knn_1_2=tuple(c.knn_1_2),
                           pop_cl50_cand=c.pop_cl50_cand, pop_cl50_ranks=c.pop_cl50_ranks,
                           pop_cl1_rank=c.pop_cl1_rank, aid_emb=c.aid_emb)
    rc = dict(cfg["retrieval"])
    rc["session_len_buckets"] = tuple(rc["session_len_buckets"])
    n = inp.stream.n_sessions
    retriever = Retriever(ctx=ctx, cfg=RetrievalConfig(**rc), sessions=SessionLookup.build(
        np.arange(n, dtype=np.int64), inp.sessions.cluster, inp.sessions.emb))
    r = cfg["ranker"]
    out = {}
    for tname, arr in zip(("clicks", "carts", "orders"), inp.rankers):
        if cfg["ranker_backend"] == "gbdt":
            gc_ = GBDTConfig(n_trees=r["n_trees"], max_depth=r["max_depth"], n_bins=r["n_bins"])
            out[tname] = GBDTRanker(gc_, arr["edges"], arr["gfeat"], arr["thr"], arr["leaf"],
                                    tuple(FEATURE_NAMES))
        else:
            tower = RankerTower(arr["norm_mean"], arr["norm_std"], arr["weights"])
            out[tname] = Ranker(RankerConfig(hidden_dims=tuple(r["hidden_dims"])),
                                tower.to(c.aid_emb.device), tuple(FEATURE_NAMES))
    return retriever, out


def _events(cols):
    from otto_tpu_torch.data.schema import Events
    return Events(*cols)


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of a serving cell -> the driver's part of the result line."""
    from otto_tpu_torch.pipeline import runner

    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    inp = Inputs(cfg, seed, dev)
    retriever, rankers = _port(cfg, inp)
    R = traffic["sessions_per_request"]
    batch = cfg["batch_sessions"]
    types = ("clicks", "carts", "orders")

    def serve(first):
        ids = inp.request(first, R)
        preds = runner.score_pass(retriever, _events(inp.columns(ids)), rankers, batch)
        return ids, preds

    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    N = inp.stream.n_sessions
    for w in range(traffic["warmup_requests"]):
        serve((N - (w + 1) * R) % N)
    if on_cuda:
        torch.cuda.synchronize()
    t_win = time.perf_counter()
    setup_s = t_win - t_start

    probe = tracing.Probe(cfg) if trace else None
    lat: List[float] = []
    done: List[tuple] = []
    attempted = failed = 0
    t_last = t_win
    i = 0
    trace_end = traffic["trace_skip_requests"] + traffic["trace_requests"]
    # a traced run reports no end-to-end metric: its window runs on until
    # the traced slice is complete
    while time.perf_counter() - t_win < seconds or (probe is not None and i < trace_end):
        if probe is not None and i == traffic["trace_skip_requests"]:
            probe.start()
        t0 = time.perf_counter()
        attempted += 1
        try:
            ids, preds = serve((i * R) % N)
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

    # every request's lists complete, each type over exactly its sessions
    missing = 0
    for ids, preds in done:
        want = np.sort(ids)
        for t in types:
            s, a = preds[t]
            if not (np.array_equal(s, want) and a.shape == (len(want), cfg["top_k"])):
                missing += len(np.setxor1d(want, s)) or len(want)
    completed = sum(len(ids) for ids, _ in done)

    served = _sample(done, inp, traffic, seed, cfg["top_k"])
    del retriever, rankers, done
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    ref = _reference(cfg, inp, sorted(served), ("full",))
    g = check.list_gaps(served, ref, cfg["top_k"])
    checks, correct = judge(cfg["correct"], g, missing)
    correct = correct and failed == 0
    finite = [x for x in lat if np.isfinite(x)]
    e2e = {"setup_s": setup_s}
    if window_s > 0:
        e2e["sessions_per_s"] = completed / window_s
    if lat:
        # the 90th percentile, interpolated between order statistics (as
        # statistics.quantiles(method="inclusive") gives it, and for one request too)
        e2e["request_p90_ms"] = 1e3 * float(np.percentile(lat, 90))
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "end_to_end": e2e, "memory_peak_bytes": int(peak), "checks": checks,
           "info": {"requests": len(lat), "sessions": completed, "window_s": window_s,
                    "latency_median_ms": 1e3 * statistics.median(finite) if finite else None,
                    "candidates_mean": _cand_mean(ref), "setup_s": setup_s}}
    if probe is not None:
        out["summary"] = probe.summary
    return out


def judge(limits: dict, g: check.Gaps, missing: int):
    """(checks, within limits): every number beside its limit; a number
    whose limit is null is printed and not compared (benchmark/PERF.md says
    why)."""
    values = {"max_gap": g.max_gap, "gapped_share": g.gapped_share, "bad_lists": g.bad_lists,
              "missing_sessions": missing}
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in values.items()}
    ok = g.lists > 0 and all(c["limit"] is None or c["value"] <= c["limit"]
                             for c in checks.values())
    checks["lists_compared"] = {"value": g.lists, "limit": None}
    return checks, ok


def _cand_mean(ref) -> float:
    n = [len(r.cand) for r in ref.values()]
    return float(np.mean(n)) if n else 0.0


def _sample(done, inp: Inputs, traffic: dict, seed: int, k: int) -> Dict[int, np.ndarray]:
    """{session: [3, k] served aids} for a sample of the served sessions,
    drawn from the seed: check_sessions of them uniformly and
    check_longest of the longest tenth (by visible length)."""
    if not done:
        return {}
    ids = np.unique(np.concatenate([d[0] for d in done]))
    rng = np.random.default_rng(sub_seeds(seed, 5)[4])
    lens = inp.stream.lengths()[ids]
    long_ids = ids[lens >= np.quantile(lens, 0.9)]
    pick = np.union1d(
        rng.choice(ids, min(traffic["check_sessions"], len(ids)), replace=False),
        rng.choice(long_ids, min(traffic["check_longest"], len(long_ids)), replace=False))
    want = set(pick.tolist())
    out = {}
    for rid, preds in done:
        s0 = preds["clicks"][0]
        hit = np.isin(s0, pick)
        for j in np.nonzero(hit)[0]:
            s = int(s0[j])
            if s in want and s not in out:
                rows = []
                for t in ("clicks", "carts", "orders"):
                    s_t, a_t = preds[t]
                    p = np.searchsorted(s_t, s)
                    ok = p < len(s_t) and s_t[p] == s
                    rows.append(a_t[p] if ok else np.full(k, -1, np.int32))
                out[s] = np.stack(rows)
    return out


def _reference(cfg: dict, inp: Inputs, sessions, precisions):
    ids = np.asarray(sessions, np.int64)
    cl = {int(s): int(inp.sessions.cluster[s]) for s in ids}
    em = {int(s): inp.sessions.emb[s] for s in ids}
    with torch.no_grad():
        return check.reference_scores(inp.columns(ids), cl, em, inp.ctx, cfg["retrieval"],
                                      cfg["ranker_backend"], inp.rankers,
                                      cfg["batch_sessions"], precisions)
