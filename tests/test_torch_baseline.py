"""The heuristic baseline (engine/baseline.py) against otto_tpu's, on
co-visitation tables each package counted from the same events, as
tests/test_e2e_slice.py runs it: the top-20 (and, batch by batch, the
scores) must be equal, and the slice must beat a popularity-only
recommender."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.config import CoVisConfig as RefCoVisConfig
from otto_tpu.data.batching import iter_microbatches, pack_sessions
from otto_tpu.data.split import split_events
from otto_tpu.data.synthetic import SyntheticSpec, generate
from otto_tpu.engine import baseline as ref_baseline
from otto_tpu.engine.covis import CoVisCounter as RefCounter
from otto_tpu_torch.config import CoVisConfig
from otto_tpu_torch.data.schema import Events
from otto_tpu_torch.engine import baseline
from otto_tpu_torch.engine.covis import CoVisCounter
from otto_tpu_torch.eval.recall import evaluate_topk
import torch_threads  # noqa: F401

N_AIDS = 800
COUNTER = dict(capacity=1 << 15, pair_budget=1 << 14, bucket_lens=(8, 32, 64))


def _port(ev):
    return Events(ev.session, ev.aid, ev.ts, ev.type)


@functools.lru_cache(maxsize=None)
def world():
    sp = split_events(generate(SyntheticSpec(
        n_sessions=1500, n_aids=N_AIDS, mean_len=12, span_days=21, seed=7)),
        test_days=7, seed=0)
    ref = RefCounter(RefCoVisConfig(), **COUNTER)
    port = CoVisCounter(CoVisConfig(), "cpu", **COUNTER)
    for part in (sp.train, sp.test):
        ref.update(part)
        port.update(_port(part))
    out = {"split": sp, "ref_tables": ref.retrieval_tables(N_AIDS),
           "port_tables": port.retrieval_tables(N_AIDS)}
    port.close()
    return out


@pytest.mark.parametrize("keep_aids", [4, 16])
def test_recommend_matches_reference(keep_aids):
    w = world()
    test = w["split"].test
    want = ref_baseline.recommend(test, w["ref_tables"], keep_aids=keep_aids, top_k=20)
    got = baseline.recommend(_port(test), w["port_tables"], keep_aids=keep_aids, top_k=20)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.int32
    assert (got[1][:, 0] >= 0).mean() > 0.95


def test_recommend_batch_scores_match_reference():
    w = world()
    names = RefCoVisConfig().names
    ref_tabs = tuple((jnp.asarray(w["ref_tables"][n].neighbor),
                      jnp.asarray(w["ref_tables"][n].count)) for n in names)
    port_tabs = tuple((w["port_tables"][n].neighbor, w["port_tables"][n].count)
                      for n in names)
    for p in pack_sessions(w["split"].test):
        mb = next(iter_microbatches(p, 64))
        want = ref_baseline.recommend_batch(
            jnp.asarray(mb.aid), jnp.asarray(mb.ts), jnp.asarray(mb.type), ref_tabs, 16, 20)
        got = baseline.recommend_batch(
            torch.from_numpy(mb.aid), torch.from_numpy(mb.ts), torch.from_numpy(mb.type),
            port_tabs, 16, 20)
        for g, r in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_slice_beats_popularity():
    w = world()
    sp = w["split"]
    sessions, aids = baseline.recommend(_port(sp.test), w["port_tables"], keep_aids=16)
    res = evaluate_topk({t: (sessions, aids) for t in ("clicks", "carts", "orders")},
                        sp.labels)
    top20 = np.argsort(-np.bincount(sp.train.aid, minlength=N_AIDS))[:20]
    pop_aids = np.tile(top20.astype(np.int32), (len(sessions), 1))
    res_pop = evaluate_topk({t: (sessions, pop_aids) for t in ("clicks", "carts", "orders")},
                            sp.labels)
    assert res["total"] > res_pop["total"] * 1.5
    assert res["total"] > 0.05
