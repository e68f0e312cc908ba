"""Cluster popularity (C12): otto_tpu_torch against otto_tpu, bit for bit.

The hand-made cases of tests/test_popularity.py (ranks and top-k, the
strict recent window, the rank lookup of absent aids) run through both
packages; then synthetic events over 7 clusters and over one, with an
event budget small enough that the ladder merges several microbatches.
All three tables must be equal.
"""
import numpy as np
import pytest
import torch

from otto_tpu.config import PopularityConfig as RefPopularityConfig
from otto_tpu.data.schema import Events as RefEvents
from otto_tpu.data.synthetic import SyntheticSpec, generate
from otto_tpu.engine.popularity import compute_popularity as ref_popularity
from otto_tpu_torch.config import PopularityConfig
from otto_tpu_torch.data.schema import Events
from otto_tpu_torch.engine.popularity import PopularityTables, compute_popularity
import torch_threads  # noqa: F401

DAY = 24 * 60 * 60


def both(ev_cols, cluster, n_clusters, n_aids, **kw):
    ref = ref_popularity(RefEvents(*ev_cols), cluster, n_clusters, n_aids,
                         RefPopularityConfig(), **kw)
    got = compute_popularity(Events(*ev_cols), cluster, n_clusters, n_aids,
                             PopularityConfig(), "cpu", **kw)
    for f, g, w in zip(PopularityTables._fields, got, ref):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
        assert g.dtype == torch.int32
    return got


def _cols(session, aid, ts, type_):
    return (np.array(session, np.int32), np.array(aid, np.int32),
            np.array(ts, np.int32), np.array(type_, np.int8))


def test_ranks_and_topk():
    # cluster 0: aid 1 clicked 3x, aid 2 once; cluster 1: aid 3 ordered
    cols = _cols([0, 0, 0, 1, 2], [1, 1, 1, 2, 3], [10, 20, 30, 40, 50], [0, 0, 0, 0, 2])
    pop = both(cols, np.array([0, 0, 0, 0, 1], np.int32), 2, 10)
    c0 = pop.candidate[0][pop.candidate[0] >= 0].tolist()
    assert set(c0) == {1, 2}
    i1 = c0.index(1)
    assert pop.ranks[0, i1, 0] == 1 and pop.ranks[0, i1, 3] == 1
    assert pop.candidate[1][pop.candidate[1] >= 0].tolist() == [3]
    assert pop.ranks[1, 0, 2] == 1


@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_recent_window_is_strict(offset):
    """An event exactly recent_window before the newest is not recent. With
    both recent, the tie ranks aid 1 (the lower) first; otherwise aid 2,
    the only recent one, is first."""
    ts_old = 10 * DAY - 7 * DAY + offset
    cols = _cols([0, 1], [1, 2], [ts_old, 10 * DAY], [0, 0])
    pop = both(cols, np.zeros(2, np.int32), 1, 5)
    cand = pop.candidate[0][pop.candidate[0] >= 0].tolist()
    i1, i2 = cand.index(1), cand.index(2)
    recent = offset > 0
    assert pop.ranks[0, i1, 3] == (1 if recent else 2)
    assert pop.ranks[0, i2, 3] == (2 if recent else 1)


def test_aid_rank_lookup():
    cols = _cols([0, 1], [4, 4], [10, 20], [1, 1])
    pop = both(cols, np.zeros(2, np.int32), 1, 8)
    assert pop.aid_rank[4, 1] == 1
    assert pop.aid_rank[7, 1] == 999


@pytest.mark.parametrize("n_clusters", [7, 1])
def test_synthetic_tables_equal(n_clusters):
    ev = generate(SyntheticSpec(n_sessions=800, n_aids=600, max_len=40, mean_len=10,
                                span_days=21, seed=4))
    cols = (ev.session, ev.aid, ev.ts, ev.type)
    cluster = np.random.default_rng(1).integers(0, n_clusters, ev.session.max() + 1)
    pop = both(cols, cluster[ev.session].astype(np.int32), n_clusters, 600,
               top_slots=16, event_budget=1 << 10)
    assert int((pop.candidate >= 0).sum()) > 0
    assert bool(((pop.ranks >= 1) & (pop.ranks <= 999)).all())


def test_empty_events():
    cols = _cols([], [], [], [])
    pop = both(cols, np.zeros(0, np.int32), 3, 4)
    assert bool((pop.candidate == -1).all()) and bool((pop.aid_rank == 999).all())
