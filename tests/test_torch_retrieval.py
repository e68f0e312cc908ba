"""Retrieval parity: otto_tpu_torch against otto_tpu on the same tables.

Tiny synthetic events, real co-visitation tables from otto_tpu's
CoVisCounter, seeded kNN / popularity / embedding tables (as bench.py
seeds them); the tables cross over with otto_tpu_torch.convert and both
packages' Retriever.iter_run run batch by batch on the CPU (the port's
kernels run as their plain twins there).

`build_world` is shared with test_torch_slice.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.config import CoVisConfig, RetrievalConfig
from otto_tpu.data.split import split_events
from otto_tpu.data.synthetic import SyntheticSpec, generate
from otto_tpu.engine import retrieval as ref_retrieval
from otto_tpu.engine.covis import CoVisCounter
from otto_tpu.engine.popularity import PopularityTables
from otto_tpu.engine.session_embed import KnnTables
from otto_tpu_torch import config as port_config
from otto_tpu_torch import convert
from otto_tpu_torch.data.schema import Events as PortEvents
from otto_tpu_torch.device import resolve
from otto_tpu_torch.engine import retrieval as port_retrieval
import torch_threads  # noqa: F401

N_AIDS = 300
EMB_D = 16
BATCH = 128
CAPS = dict(max_session_aids=16, max_candidates=64, session_len_buckets=(8, 32))
CFG = RetrievalConfig(**CAPS)
PORT_CFG = port_config.RetrievalConfig(**CAPS)

# Float-valued features and their tolerance. cos_sim / eucl_dist: the
# session-candidate dot product and norms are reduced in another order by
# torch's einsum / linalg.norm than by XLA's (f32, TF32 off), a few ulps of
# relative difference. dist_w2vec_*: a float sum over the candidate's
# segment; heur_score: a float sum of per-source terms. Everything else is
# integer-valued and must be bit-equal.
FLOAT_FEATURES = (
    "cos_sim_ses_aid", "eucl_dist_ses_aid",
    "dist_w2vec_all", "dist_w2vec_1_2", "heur_score",
)
FLOAT_RTOL = FLOAT_ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def build_world():
    """-> dict(split, the port's copy of the test events, ref retriever,
    port retriever) on tiny shapes."""
    spec = SyntheticSpec(
        n_sessions=1500, n_aids=N_AIDS, max_len=40, mean_len=10,
        span_days=21, seed=11,
    )
    sp = split_events(generate(spec), test_days=7, seed=0)
    counter = CoVisCounter(
        CoVisConfig(), capacity=1 << 16, pair_budget=1 << 15,
        bucket_lens=(64,), spill=False,
    )
    counter.update(sp.train)
    tables = counter.retrieval_tables(N_AIDS)
    covis = [
        tuple(np.asarray(a) for a in tables[n]) for n in CoVisConfig().names
    ]

    rng = np.random.default_rng(5)
    k = 20

    def knn():
        return KnnTables(
            neighbor=rng.integers(-1, N_AIDS, (N_AIDS, k)).astype(np.int32),
            dist=rng.random((N_AIDS, k)).astype(np.float32),
        )

    knn_all, knn_12 = knn(), knn()
    pop50 = PopularityTables(
        candidate=rng.integers(-1, N_AIDS, (50, 32)).astype(np.int32),
        ranks=rng.integers(1, 60, (50, 32, 6)).astype(np.int32),
        aid_rank=np.zeros((0, 6), np.int32),
    )
    pop1 = PopularityTables(
        candidate=np.zeros((1, 0), np.int32),
        ranks=np.zeros((1, 0, 6), np.int32),
        aid_rank=rng.integers(1, 999, (N_AIDS, 6)).astype(np.int32),
    )
    aid_emb = rng.normal(size=(N_AIDS, EMB_D)).astype(np.float32)
    aid_emb[rng.random(N_AIDS) < 0.05] = 0.0      # aids without an embedding

    sessions = np.unique(sp.test.session)
    clusters = rng.integers(0, 50, len(sessions)).astype(np.int32)
    ses_emb = rng.normal(size=(len(sessions), EMB_D)).astype(np.float32)

    ref_ctx = ref_retrieval.RetrievalContext(
        covis=tuple(tables[n] for n in CoVisConfig().names),
        knn_all=(jnp.asarray(knn_all.neighbor), jnp.asarray(knn_all.dist)),
        knn_1_2=(jnp.asarray(knn_12.neighbor), jnp.asarray(knn_12.dist)),
        pop_cl50_cand=jnp.asarray(pop50.candidate),
        pop_cl50_ranks=jnp.asarray(pop50.ranks),
        pop_cl1_rank=jnp.asarray(pop1.aid_rank),
        aid_emb=jnp.asarray(aid_emb),
    )
    ref = ref_retrieval.Retriever(
        ctx=ref_ctx, cfg=CFG,
        sessions=ref_retrieval.SessionLookup.build(sessions, clusters, ses_emb),
    )
    port_ctx = convert.context_from_numpy(
        covis, knn_all, knn_12, pop50, pop1, aid_emb,
        resolve("cpu"),
    )
    port = port_retrieval.Retriever(
        ctx=port_ctx, cfg=PORT_CFG,
        sessions=port_retrieval.SessionLookup.build(sessions, clusters, ses_emb),
    )
    t = sp.test
    port_test = PortEvents(t.session, t.aid, t.ts, t.type)
    return {"split": sp, "port_test": port_test, "ref": ref, "port": port}


@functools.lru_cache(maxsize=None)
def retrieved():
    """Both packages' iter_run, keep-filtered to host arrays."""
    w = build_world()

    def pull(batches, to_np):
        return [
            (np.asarray(b.session), np.asarray(b.cand), to_np(b.feats),
             np.asarray(b.ts_order))
            for b in batches
        ]

    ref = pull(w["ref"].iter_run(w["split"].test, batch_sessions=BATCH),
               np.asarray)
    port = pull(w["port"].iter_run(w["port_test"], batch_sessions=BATCH),
                lambda t: t.numpy())
    return ref, port


def test_feature_names_match_reference():
    assert port_retrieval.FEATURE_NAMES == ref_retrieval.FEATURE_NAMES
    assert port_retrieval.SOURCE_FLAGS == ref_retrieval.SOURCE_FLAGS
    assert port_retrieval.COVIS_NAMES == ref_retrieval.COVIS_NAMES
    assert port_retrieval.AID_BITS == ref_retrieval.AID_BITS


def test_batches_align():
    ref, port = retrieved()
    assert len(ref) == len(port) >= 3
    # a padded tail batch is among them (keep filter exercised)
    assert any(len(r[0]) < BATCH for r in ref)
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(r[0], p[0])


def test_candidates_bit_equal():
    ref, port = retrieved()
    n_cand = 0
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p[1], r[1])
        np.testing.assert_array_equal(p[3], r[3])
        n_cand += int((r[1] >= 0).sum())
    assert n_cand > 1000  # the sources really produced candidates


@pytest.mark.parametrize("name", ref_retrieval.FEATURE_NAMES)
def test_feature_parity(name):
    ref, port = retrieved()
    j = ref_retrieval.FEATURE_INDEX[name]
    for r, p in zip(ref, port):
        want, got = r[2][..., j], p[2][..., j]
        if name in FLOAT_FEATURES:
            np.testing.assert_allclose(
                got, want, rtol=FLOAT_RTOL, atol=FLOAT_ATOL, err_msg=name
            )
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_retrieve_batch_keeps_int32_layout():
    w = build_world()
    ref, port = retrieved()
    assert port[0][1].dtype == np.int32 and port[0][2].dtype == np.float32
    ctx = w["port"].ctx
    assert ctx.covis[0].neighbor.dtype == torch.int32
    assert ctx.aid_emb.dtype == torch.float32


def test_context_moves_as_a_whole():
    """RetrievalContext.to / .tensors cover every table (the cross-check of
    chip_smoke.py moves a context with them)."""
    ctx = build_world()["port"].ctx
    tabs = ctx.tensors()
    assert len(tabs) == 5 * 5 + 2 + 2 + 4
    moved = ctx.to("meta")
    assert type(moved) is type(ctx)
    assert type(moved.covis[0]) is type(ctx.covis[0])
    assert all(t.device.type == "meta" for t in moved.tensors())
    assert [t.shape for t in moved.tensors()] == [t.shape for t in tabs]


def test_history_reaches_the_consumer():
    """Each batch of the port's iter_run carries the padded (aid, ts, type)
    it was retrieved from, keep-filtered like its candidates: row i holds
    session i's last events (at most the bucket's lanes), left-aligned."""
    w = build_world()
    t = w["port_test"]
    n_rows = 0
    for b in w["port"].iter_run(t, batch_sessions=BATCH):
        aid, ts, typ = (x.numpy() for x in b.history_device())
        assert aid.shape[0] == len(b.session) == b.cand_device().shape[0]
        for i, s in enumerate(b.session):
            m = t.session == s
            n = min(int(m.sum()), aid.shape[1])
            np.testing.assert_array_equal(aid[i, :n], t.aid[m][-n:])
            np.testing.assert_array_equal(ts[i, :n], t.ts[m][-n:])
            np.testing.assert_array_equal(typ[i, :n], t.type[m][-n:])
            assert (aid[i, n:] == -1).all()
            n_rows += 1
    assert n_rows == len(np.unique(t.session))


def test_hstu_serves_through_score_pass():
    """ranker_backend "hstu" on the port's serving path: score_pass with
    one HSTU ranker for the three targets ranks each session's retrieved
    candidates as the plain reference scores them from its events
    (tests/hstu_reference.py; gaps within test_torch_hstu.TOL)."""
    from otto_tpu_torch.config import TYPES
    from otto_tpu_torch.models.hstu import HSTURanker
    from otto_tpu_torch.pipeline import runner
    import hstu_reference as ref_hstu
    from test_torch_hstu import CFG, TOL, draw_params

    w = build_world()
    t = w["port_test"]
    params = draw_params(n_aids=N_AIDS, seed=3)
    r = HSTURanker(CFG, params, tuple(port_retrieval.FEATURE_NAMES))
    preds = runner.score_pass(w["port"], t, {tn: r for tn in TYPES}, BATCH)
    cand_of = {}
    for b in w["port"].iter_run(t, batch_sessions=BATCH):
        for i, s in enumerate(b.session):
            cand_of[int(s)] = (b.cand[i], b.feats[i].numpy())
    checked = 0
    for ti, tn in enumerate(TYPES):
        sess, aids = preds[tn]
        np.testing.assert_array_equal(sess, np.unique(t.session))
        for s, row in list(zip(sess, aids))[::7]:
            m = t.session == s
            cand, feats = cand_of[int(s)]
            ok = cand >= 0
            want = ref_hstu.session_scores(params, CFG, t.aid[m][-32:], t.ts[m][-32:],
                                           t.type[m][-32:], cand[ok], feats[ok])[ti].numpy()
            got = row[row >= 0]
            assert len(got) == min(20, int(ok.sum()))
            by_aid = dict(zip(cand[ok].tolist(), want.tolist()))
            served = np.array([by_aid[a] for a in got.tolist()])
            best = np.sort(want)[::-1][:len(got)]
            assert (best - served).max(initial=0.0) <= TOL
            checked += 1
    assert checked > 100
