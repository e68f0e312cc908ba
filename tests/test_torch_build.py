"""The table build slice against otto_tpu: co-visitation counting (C7),
kNN tables (C9), session embeddings (C10), k-means clusters (C11) and
cluster popularity (C12), then serving from them.

The reference side calls otto_tpu's C7 and C9-C12 functions in the order
of its Pipeline.build_retriever (runner.py:678-836) on the tiny synthetic
data of test_torch_retrieval.py's world and two seeded word2vec models;
the port runs its build_retriever on the CPU with the same inputs. The
counting config is otto_tpu's but for a small pair budget and run size
and a low spill-prune threshold, so the ladder merges, spills and prunes.
k-means starts from otto_tpu's k-means++ centroids on both sides
(test_torch_kmeans.py says why).

Tolerances: kNN distances within 1e-5 relative + 1e-4 absolute and
session embeddings within one float16 ulp (test_torch_session_embed.py
says why); the co-visitation and popularity tables, neighbours, session
ids, cluster labels and the served top-20 are equal (the seeded rankers
split only on integer-valued features, see test_torch_slice.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.config import TYPES
from otto_tpu.config import CoVisConfig as RefCoVisConfig
from otto_tpu.config import PopularityConfig as RefPopularityConfig
from otto_tpu.config import Word2VecConfig as RefW2VConfig
from otto_tpu.data.batching import pack_sessions as ref_pack_sessions
from otto_tpu.engine import retrieval as ref_retrieval
from otto_tpu.engine.covis import CoVisCounter as RefCoVisCounter
from otto_tpu.engine.popularity import compute_popularity as ref_popularity
from otto_tpu.engine.retrieval import FEATURE_INDEX
from otto_tpu.engine import session_embed as ref_se
from otto_tpu.eval.diagnostics import w2vec_covis_overlap as ref_overlap
from otto_tpu.eval.diagnostics import write_overlap_report as ref_write_overlap
from otto_tpu.models.word2vec import Word2Vec as RefWord2Vec
from otto_tpu.models.word2vec import build_vocab as ref_build_vocab
from otto_tpu.ops import kmeans as ref_kmeans
from otto_tpu_torch import convert
from otto_tpu_torch.config import CoVisConfig, Word2VecConfig
from otto_tpu_torch.data.schema import Events
from otto_tpu_torch.engine.covis import CoVisTables
from otto_tpu_torch.engine.session_embed import build_knn_tables
from otto_tpu_torch.models.word2vec import train_word2vec_device
from otto_tpu_torch.ops import kmeans as port_kmeans
from otto_tpu_torch.pipeline import runner as port_runner
from test_torch_retrieval import BATCH, CFG, N_AIDS, PORT_CFG, build_world
from test_torch_session_embed import assert_within_f16_ulp
from test_torch_slice import _ref_pipeline, seeded_rankers
import torch_threads  # noqa: F401

N_CLUSTERS = 50
FIRST_N = 200     # kNN queries: fewer than the vocabulary, so some rows stay -1
COUNTING = dict(pair_budget=1 << 12, max_run_rows=1 << 14, spill_prune_min_rows=64)


def _ref_models(full):
    rng = np.random.default_rng(21)
    out = {}
    for name, types in (("w2v-all", (0, 1, 2)), ("w2v-1-2", (1, 2))):
        cfg = RefW2VConfig(name=name, types=types, vector_size=16, min_count=1,
                           knn_k=20, knn_first_n_aids=FIRST_N)
        vocab = ref_build_vocab(full, types, cfg.min_count, N_AIDS)
        out[name] = RefWord2Vec(cfg, vocab, rng.normal(size=(vocab.size, 16)).astype(np.float32))
    return out


@functools.lru_cache(maxsize=None)
def build_both(tmp_root):
    w = build_world()
    sp = w["split"]
    full = sp.train.concat(sp.test)
    models = _ref_models(full)

    # ---- otto_tpu, in runner.py's order ------------------------------------
    counter = RefCoVisCounter(dataclasses.replace(RefCoVisConfig(), **COUNTING))
    counter.update(sp.train)
    counter.update(sp.test)
    covis = counter.retrieval_tables(N_AIDS)
    covis = tuple(covis[n] for n in RefCoVisConfig().names)
    knns = {n: ref_se.build_knn_tables(m, N_AIDS) for n, m in models.items()}
    co_nbr = np.asarray(covis[0].neighbor)
    ref_stats = {n: ref_overlap(knns[n].neighbor, co_nbr) for n in models}
    aid_emb = models["w2v-all"].embedding_by_aid(N_AIDS)
    sess_ids, sess_emb = ref_se.compute_session_embeddings(ref_pack_sessions(full), aid_emb)
    # the start both fits share: otto_tpu's k-means++ as its _fit_core draws
    # it (fewer sessions than the 64k init sample: seeded on all of them)
    assert len(sess_ids) < 1 << 16
    _, kinit = jax.random.split(jax.random.PRNGKey(42))
    init = np.array(ref_kmeans._kmeanspp_init_device(jnp.asarray(sess_emb), N_CLUSTERS, kinit))
    _, labels, _, _ = ref_kmeans.kmeans_fit(sess_emb, N_CLUSTERS, max_iter=100, tol=1e-3, seed=42)
    pos = np.clip(np.searchsorted(sess_ids, full.session), 0, len(sess_ids) - 1)
    ev_cluster = np.where(sess_ids[pos] == full.session, labels[pos], 0).astype(np.int32)
    pop50 = ref_popularity(full, ev_cluster, N_CLUSTERS, N_AIDS, RefPopularityConfig())
    pop1 = ref_popularity(full, np.zeros(len(full), np.int32), 1, N_AIDS,
                          RefPopularityConfig())
    ref = ref_retrieval.Retriever(
        ctx=w["ref"].ctx._replace(
            covis=covis,
            knn_all=tuple(jnp.asarray(a) for a in knns["w2v-all"]),
            knn_1_2=tuple(jnp.asarray(a) for a in knns["w2v-1-2"]),
            pop_cl50_cand=jnp.asarray(pop50.candidate),
            pop_cl50_ranks=jnp.asarray(pop50.ranks),
            pop_cl1_rank=jnp.asarray(pop1.aid_rank),
            aid_emb=jnp.asarray(aid_emb)),
        cfg=CFG,
        sessions=ref_retrieval.SessionLookup.build(sess_ids, labels, sess_emb),
    )

    # ---- the port ----------------------------------------------------------
    def reference_init(x, k, init_sample, generator):
        assert k == N_CLUSTERS
        return torch.from_numpy(init)

    def ev(e):
        return Events(e.session, e.aid, e.ts, e.type)

    report_dir = tmp_root / "build"
    report_dir.mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_kmeans, "init_centroids", reference_init)
        port, report = port_runner.build_retriever(
            ev(sp.train), ev(sp.test),
            models={n: convert.word2vec_from_numpy(m) for n, m in models.items()},
            n_aids=N_AIDS, device="cpu",
            covis=dataclasses.replace(CoVisConfig(), **COUNTING),
            retrieval=PORT_CFG, report_dir=str(report_dir),
        )
    return {"w": w, "covis": covis, "counter": counter, "pop50": pop50, "pop1": pop1,
            "knns": knns, "ref_stats": ref_stats, "sess_ids": sess_ids,
            "sess_emb": sess_emb, "labels": labels, "ref": ref, "port": port,
            "report": report, "report_dir": report_dir, "models": models, "init": init}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return build_both(tmp_path_factory.getbasetemp())


def test_covis_tables_equal(both):
    """All five fields of the five tables, counted from train then test."""
    for name, got, want in zip(RefCoVisConfig().names, both["port"].ctx.covis,
                               both["covis"]):
        assert isinstance(got, CoVisTables)
        for f, g, w in zip(CoVisTables._fields, got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{name}.{f}")
    assert int((both["port"].ctx.covis[0].neighbor[:, 0] >= 0).sum()) > 0


def test_covis_report_matches_counter(both):
    rep, ref = both["report"].covis, both["counter"]
    assert rep["rows_spilled"] == ref._store.rows_spilled > 0
    assert rep["rows_pruned"] == ref._ladder.rows_pruned > 0
    assert rep["host_merge"] == "c++"
    assert rep["microbatches"] > 0 and rep["pairs"] > 0 and rep["host_seconds"] > 0
    for name, t in zip(RefCoVisConfig().names, both["covis"]):
        assert rep["rows_with_neighbours"][name] == int((np.asarray(t.neighbor)[:, 0] >= 0).sum())
        assert rep["unique_pairs"][name][0] >= rep["unique_pairs"][name][1]


def test_popularity_tables_equal(both):
    ctx = both["port"].ctx
    np.testing.assert_array_equal(ctx.pop_cl50_cand.numpy(), both["pop50"].candidate)
    np.testing.assert_array_equal(ctx.pop_cl50_ranks.numpy(), both["pop50"].ranks)
    np.testing.assert_array_equal(ctx.pop_cl1_rank.numpy(), both["pop1"].aid_rank)
    pop = both["report"].popularity
    assert pop["cl50"]["clusters"] == N_CLUSTERS and pop["cl1"]["clusters"] == 1
    assert pop["cl50"]["candidates_total"] == int((both["pop50"].candidate >= 0).sum()) > 0


@pytest.mark.parametrize("name,field", [("w2v-all", "knn_all"), ("w2v-1-2", "knn_1_2")])
def test_knn_tables_equal(both, name, field):
    nbr, dist = getattr(both["port"].ctx, field)
    want = both["knns"][name]
    np.testing.assert_array_equal(nbr.numpy(), want.neighbor)
    np.testing.assert_allclose(dist.numpy(), want.dist, rtol=1e-5, atol=1e-4)
    assert int((nbr[:, 0] >= 0).sum()) == FIRST_N


def test_item_embeddings_are_the_main_models(both):
    want = both["models"]["w2v-all"].embedding_by_aid(N_AIDS)
    np.testing.assert_array_equal(both["port"].ctx.aid_emb.numpy(), want)


def test_session_embeddings_equal(both):
    lookup = both["port"].sessions
    np.testing.assert_array_equal(lookup.ids, both["sess_ids"])
    assert_within_f16_ulp(lookup.emb, both["sess_emb"])
    # train + test sessions
    w = both["w"]
    n = len(np.unique(np.concatenate([w["split"].train.session, w["split"].test.session])))
    assert len(lookup.ids) == n


def test_cluster_labels_equal(both):
    lookup = both["port"].sessions
    np.testing.assert_array_equal(lookup.cluster, both["labels"])
    km = both["report"].kmeans
    assert km["n_points"] == len(both["labels"])
    assert km["n_nonempty"] == len(np.unique(both["labels"])) > 1
    assert 0 < km["n_iter"] <= 100 and km["inertia"] > 0


def test_overlap_report_equal(both, tmp_path):
    for name, stats in both["ref_stats"].items():
        assert both["report"].overlap[name] == stats
        ref_write_overlap(str(tmp_path / name), stats)
        got = (both["report_dir"] / f"stats_w2vec_x_co_click-{name}.csv").read_text()
        assert got == (tmp_path / name).read_text()
    assert set(both["report"].seconds) == {
        "covis count", "covis tables", "knn w2v-all", "knn w2v-1-2", "overlap", "session_emb", "kmeans",
        "popularity", "context"}


def test_top20_from_built_tables_equal(both, tmp_path):
    """score_pass over the tables each package built."""
    sp = both["w"]["split"]
    batches = [np.asarray(b.feats) for b in both["ref"].iter_run(sp.test, BATCH)]
    flat = np.concatenate([f.reshape(-1, f.shape[-1]) for f in batches])
    ref_rankers = seeded_rankers(flat[flat[:, FEATURE_INDEX["src_any"]] > 0])
    want = _ref_pipeline(tmp_path)._score_pass(both["ref"], sp.test, ref_rankers, BATCH)
    got = port_runner.score_pass(
        both["port"], both["w"]["port_test"],
        {t: convert.gbdt_from_numpy(r) for t, r in ref_rankers.items()}, BATCH)
    for t in TYPES:
        np.testing.assert_array_equal(got[t][0], want[t][0])
        np.testing.assert_array_equal(got[t][1], want[t][1])
    assert (got["clicks"][1][:, 0] >= 0).mean() > 0.9


def _ev(e):
    return Events(e.session, e.aid, e.ts, e.type)


def _port_build(both, models, **kw):
    """The port's build as build_both runs it."""
    sp = both["w"]["split"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_kmeans, "init_centroids", lambda x, k, s, g: torch.from_numpy(both["init"]))
        return port_runner.build_retriever(
            _ev(sp.train), _ev(sp.test), N_AIDS, "cpu", models=models,
            covis=dataclasses.replace(CoVisConfig(), **COUNTING), retrieval=PORT_CFG, **kw)


def test_models_go_by_name_not_order(both):
    """A models dict in the other order gives the same context: the first
    name of w2vec is the main model and knn_all, the second knn_1_2; the
    overlap reads the click_to_click table by name."""
    reordered = {n: convert.word2vec_from_numpy(both["models"][n])
                 for n in ("w2v-1-2", "w2v-all")}
    port, report = _port_build(both, reordered)
    for got, want in zip(port.ctx.tensors(), both["port"].ctx.tensors()):
        assert torch.equal(got, want)
    assert list(report.overlap) == ["w2v-all", "w2v-1-2"]
    assert report.overlap == both["report"].overlap
    with pytest.raises(ValueError, match="not in w2vec"):
        port_runner.build_retriever(None, None, N_AIDS, "cpu",
                                    models={"w2v-x": reordered["w2v-all"]})


def test_missing_models_are_trained(both):
    """build_retriever trains the models of w2vec it is not given, on
    train + test, and times each as 'w2vec {name}'."""
    # a few steps: no rounding up to 64-step dispatches
    w2vec = {"w2v-all": Word2VecConfig(name="w2v-all", vector_size=16, min_count=1),
             "w2v-1-2": Word2VecConfig(name="w2v-1-2", types=(1, 2), vector_size=16,
                                       min_count=1, epochs=2, batch_size=4096,
                                       steps_per_dispatch=1, knn_first_n_aids=FIRST_N)}
    given = convert.word2vec_from_numpy(both["models"]["w2v-all"])
    port, report = _port_build(both, {"w2v-all": given}, w2vec=w2vec)
    assert "w2vec w2v-1-2" in report.seconds and "w2vec w2v-all" not in report.seconds
    assert list(report.w2vec) == ["w2v-1-2"] and report.w2vec["w2v-1-2"].mode == "pair"
    sp = both["w"]["split"]
    full = _ev(sp.train).concat(_ev(sp.test))
    trained = train_word2vec_device(full, w2vec["w2v-1-2"], N_AIDS, device="cpu")
    want = build_knn_tables(trained, N_AIDS, "cpu")
    assert torch.equal(port.ctx.knn_1_2[0], want.neighbor)
    assert torch.equal(port.ctx.knn_1_2[1], want.dist)
    assert torch.equal(port.ctx.knn_all[0], both["port"].ctx.knn_all[0])
    assert torch.equal(port.ctx.aid_emb, both["port"].ctx.aid_emb)
