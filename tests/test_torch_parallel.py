"""The port's multi-device paths on N ranks, against its one-rank run and
against otto_tpu's mesh on 4 of its virtual CPU devices.

Mirrors tests/test_sharded_covis.py and tests/test_mesh_stages.py case
for case (the mesh-spec parser and the CLI run are in
test_torch_pipeline_mesh.py), plus one case per ported module: the
sharded co-visitation counter (with and without the spill-time prune,
and its bounded table),
dp k-means, dp GBDT and data-sharded retrieval.

Four ranks start once, over gloo with a FileStore (no ports), and run
every case on the meshes data=4 and data=2,model=2 (SGNS: model=4 and
data=2,model=2); their code is tests/torch_mesh_ranks.py. The inputs are
made here from numpy seeds, with otto_tpu's draws where a case injects
them (SGNS's threefry stream and start table, k-means++ per shard, the
GBDT's per-shard bags).

Tolerances: integer and id outputs bit-equal (co-visitation tables,
popularity, kNN ids, cluster labels, candidates, the features' integer
columns, label bits); dp k-means bit-equal to one rank from the same
start, and from its own seeding to kmeans_fit; session embeddings bit-equal to one rank and within
one float16 ulp of otto_tpu's; model-parallel SGNS bit-equal to the
port's one device and, from otto_tpu's start and draws at 1024 pairs a
step, within rtol 2e-4, atol 2e-5 of otto_tpu's (at the reference test's
512 pairs, 32 steps at lr 0.25 carry float32 rounding-order differences
past 1e-3, and the port's one-device training is as far from otto_tpu's;
one step agrees within 1e-5, tests/test_torch_word2vec.py); dp GBDT
bit-equal to one rank from the same bag (injected, and by default), and
from otto_tpu's per-shard draws the same splits with leaves within 2e-4.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from otto_tpu.config import CoVisConfig as RefCoVisConfig
from otto_tpu.config import GBDTConfig as RefGBDTConfig
from otto_tpu.config import PopularityConfig as RefPopularityConfig
from otto_tpu.config import Word2VecConfig as RefW2VConfig
from otto_tpu.data.batching import iter_microbatches as ref_microbatches
from otto_tpu.data.batching import pack_sessions as ref_pack
from otto_tpu.data.split import split_events
from otto_tpu.data.synthetic import SyntheticSpec, generate
from otto_tpu.engine.popularity import compute_popularity as ref_popularity
from otto_tpu.engine.session_embed import compute_session_embeddings as ref_session_emb
from otto_tpu.models import gbdt as ref_gbdt
from otto_tpu.models import word2vec as ref_w2v
from otto_tpu.ops import kmeans as ref_kmeans
from otto_tpu.ops.knn import knn_search as ref_knn
from otto_tpu.parallel import collectives as ref_coll
from otto_tpu.parallel.mesh import make_mesh as ref_make_mesh
from otto_tpu_torch.config import (
    CoVisConfig,
    GBDTConfig,
    PopularityConfig,
    RetrievalConfig,
    Word2VecConfig,
)
from otto_tpu_torch.data.batching import pack_sessions
from otto_tpu_torch.data.schema import Events, Labels
from otto_tpu_torch.engine.covis import CoVisCounter
from otto_tpu_torch.engine.popularity import PopularityTables, compute_popularity
from otto_tpu_torch.engine.retrieval import Retriever, SessionLookup, label_keys_device
from otto_tpu_torch.engine.session_embed import (
    compute_session_embeddings,
    session_embedding_batch,
)
from otto_tpu_torch.models.gbdt import train_gbdt_ranker
from otto_tpu_torch.models.word2vec import build_vocab, flat_corpus, train_word2vec_device
from otto_tpu_torch.ops import counts as counts_ops
from otto_tpu_torch.ops.kmeans import kmeans_fit, lloyd_fit
from otto_tpu_torch.ops.knn import knn_search
from otto_tpu_torch.parallel.distributed import spawn_ranks
from test_torch_gbdt_train import _synthetic_ranking
from test_torch_word2vec import epoch_draws, ref_pair_draws

CPU = torch.device("cpu")
MESHES = [ranks.mesh_name(*m) for m in ranks.DATA_MESHES]
SGNS_MESHES = [ranks.mesh_name(*m) for m in ranks.SGNS_MESHES]
N_DATA = {"4x1": 4, "2x2": 2, "1x4": 1}
RANKS = range(4)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs >= 4 devices")


def ev_dict(ev):
    return {"session": ev.session, "aid": ev.aid, "ts": ev.ts, "type": ev.type}


def port_ev(ev):
    return Events(ev.session, ev.aid, ev.ts, ev.type)


def ref_mesh(name):
    """otto_tpu's mesh with the data axis of the port's mesh `name`."""
    d, m = (int(x) for x in name.split("x"))
    return ref_make_mesh(jax.devices()[:4], data_parallel=d, model_parallel=m)


def ref_kmeans_dp_init(x, k, seed, init_sample, n):
    """The centroids otto_tpu's kmeans_fit_dp seeds on n shards (its
    _fit_core with an axis: a per-shard subsample, all-gathered)."""
    kseed, kinit = jax.random.split(jax.random.PRNGKey(seed))
    per = max(1, init_sample // n)
    shards = np.split(x, n)
    picks = [s[np.asarray(jax.random.choice(jax.random.fold_in(kseed, i), len(s), (per,),
                                            replace=False))]
             for i, s in enumerate(shards)]
    return np.array(ref_kmeans._kmeanspp_init_device(jnp.asarray(np.concatenate(picks)), k,
                                                     kinit))


def ref_gbdt_draws(cfg, n_features, n_groups, n):
    """otto_tpu's per-tree draws on n shards: the column subset of
    fold_in(key0, t), each shard's bag from fold_in(k_bag, shard)."""
    n_sub = max(1, int(round(cfg.colsample * n_features)))
    local = ranks.gbdt_rows(n_groups, n) // n
    key0 = jax.random.PRNGKey(cfg.seed)
    out = {}
    for t in range(cfg.n_trees):
        k_feat, k_bag = jax.random.split(jax.random.fold_in(key0, t))
        feat = np.asarray(jax.random.permutation(k_feat, n_features)[:n_sub]).astype(np.int64)
        bags = [np.asarray(jax.random.uniform(jax.random.fold_in(k_bag, s), (local,))
                           < cfg.subsample) for s in range(n)]
        out[t] = (feat, bags)
    return out


def retrieval_world():
    """A small retrieval context as numpy (port classes only), the test
    events and labels."""
    spec = SyntheticSpec(n_sessions=900, n_aids=300, max_len=40, mean_len=10, span_days=21,
                         seed=11)
    sp = split_events(generate(spec), test_days=7, seed=0)
    counter = CoVisCounter(CoVisConfig(), CPU, pair_budget=1 << 15)
    try:
        counter.update(port_ev(sp.train))
        tables = counter.retrieval_tables(300)
    finally:
        counter.close()
    rng = np.random.default_rng(5)

    def knn():
        return (rng.integers(-1, 300, (300, 20)).astype(np.int32),
                rng.random((300, 20)).astype(np.float32))

    sessions = np.unique(sp.test.session)
    return {
        "covis": [tuple(x.numpy() for x in tables[n]) for n in CoVisConfig().names],
        "knn_all": knn(), "knn_12": knn(),
        "pop50": PopularityTables(rng.integers(-1, 300, (50, 32)).astype(np.int32),
                                  rng.integers(1, 60, (50, 32, 6)).astype(np.int32),
                                  np.zeros((0, 6), np.int32)),
        "pop1": PopularityTables(np.zeros((1, 0), np.int32), np.zeros((1, 0, 6), np.int32),
                                 rng.integers(1, 999, (300, 6)).astype(np.int32)),
        "aid_emb": rng.normal(size=(300, 16)).astype(np.float32),
        "sessions": (sessions, rng.integers(0, 50, len(sessions)).astype(np.int32),
                     rng.normal(size=(len(sessions), 16)).astype(np.float32)),
        "test": ev_dict(sp.test),
        "labels": Labels(sp.labels.session, sp.labels.aid, sp.labels.type),
        "batch": 96,    # neither 4 nor 2 ranks split a bucket's tail evenly
    }


def make_inputs():
    inp = {
        "covis_ev": ev_dict(generate(SyntheticSpec(n_sessions=256, n_aids=400, max_len=24,
                                                   mean_len=8, seed=9))),
        "owner_ev": ev_dict(generate(SyntheticSpec(n_sessions=128, n_aids=200, max_len=16,
                                                   mean_len=6, seed=3))),
        "counter_ev": ev_dict(generate(SyntheticSpec(n_sessions=400, n_aids=300, mean_len=8,
                                                     seed=23))),
        "emb_ev": ev_dict(generate(SyntheticSpec(n_sessions=500, n_aids=400, mean_len=6,
                                                 seed=3))),
        "emb_table": np.random.default_rng(0).normal(size=(400, 32)).astype(np.float32),
        "pop_ev": ev_dict(generate(SyntheticSpec(n_sessions=600, n_aids=300, mean_len=7,
                                                 seed=9))),
        "knn_corpus": np.random.default_rng(2).normal(size=(700, 24)).astype(np.float32),
        "sgns_ev": ev_dict(generate(SyntheticSpec(n_sessions=400, n_aids=300, mean_len=8,
                                                  seed=13))),
    }
    inp["pop_cl"] = np.random.default_rng(1).integers(0, 5, len(inp["pop_ev"]["aid"])
                                                      ).astype(np.int32)
    # SGNS: otto_tpu's start table and threefry stream, step by step
    ev = port_ev(generate(SyntheticSpec(n_sessions=400, n_aids=300, mean_len=8, seed=13)))
    cfg = Word2VecConfig(**ranks.SGNS_REF_CFG)
    vocab = build_vocab(ev, cfg.types, cfg.min_count, None)
    _, cum = flat_corpus(ev, vocab, cfg.types)
    chunk = cfg.steps_per_dispatch
    n_steps = -(-max(1, int(cum[-1]) * cfg.window // cfg.batch_size) // chunk) * chunk
    neg_shape = (max(1, cfg.batch_size // min(256, cfg.batch_size)), cfg.negatives * 8)
    one = epoch_draws(cfg.seed, cfg.epochs, chunk, lambda key: ref_pair_draws(
        key, cfg.batch_size, cfg.window, neg_shape))
    inp["sgns_draws"] = {(e, i): {k: v.numpy() for k, v in one(e, i).items()}
                         for e in range(cfg.epochs) for i in range(n_steps)}
    inp["sgns_start"] = np.asarray(ref_w2v.init_params(vocab.size, cfg.vector_size,
                                                       cfg.seed).emb_in)
    # k-means blobs and otto_tpu's per-shard seeding for 4 and 2 shards
    from test_torch_kmeans import blobs

    inp["km_x"] = blobs(4)
    inp["km_init"] = {n: ref_kmeans_dp_init(inp["km_x"], 6, 3, 200, n) for n in (4, 2)}
    # GBDT rows, one bag over the 4-rank layout, otto_tpu's per-shard draws
    x, y, sess = _synthetic_ranking(n_groups=90)
    inp["gbdt_rows"] = (x, y, sess)
    inp["gbdt_valid"] = _synthetic_ranking(n_groups=24, seed=5)
    cfg = GBDTConfig(**ranks.GBDT_CFG)
    n_sub = max(1, int(round(cfg.colsample * x.shape[1])))
    bag = {}
    for t in range(cfg.n_trees):
        g = torch.Generator().manual_seed(1000 + t)
        bag[t] = (torch.randperm(x.shape[1], generator=g)[:n_sub].numpy(),
                  (torch.rand(ranks.gbdt_rows(90, 4), generator=g) < cfg.subsample).numpy())
    inp["gbdt_bag"] = bag
    inp["gbdt_ref_draws"] = {n: ref_gbdt_draws(cfg, x.shape[1], 90, n) for n in (4, 2)}
    inp["retrieval"] = retrieval_world()
    return inp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, [rank r's results]) of one start of four ranks."""
    tmp = tmp_path_factory.mktemp("parallel")
    inp = make_inputs()
    with open(tmp / "inputs.pkl", "wb") as fh:
        pickle.dump(inp, fh)
    spawn_ranks(ranks.run_parallel_cases, 4, args=(str(tmp),), device="cpu", threads=1,
                store_path=str(tmp / "store"))
    out = []
    for r in RANKS:
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return inp, out


def replicated(out, mesh, key):
    """A result every rank holds: the same on every rank -> rank 0's."""
    first = out[0][mesh][key]
    for r in RANKS:
        np.testing.assert_equal(out[r][mesh][key], first)
    return first


# ---------------------------------------------------------------------------
# tests/test_sharded_covis.py
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def covis_refs(world):
    inp, _ = world
    cfg = CoVisConfig()
    ev = port_ev(Events(**inp["covis_ev"]))
    single = CoVisCounter(cfg, CPU, capacity=1 << 15, bucket_lens=(32,))
    try:
        single.update(ev)
        port = {n: tuple(np.asarray(x) for x in t[:3]) for n, t in single.tables.items()}
    finally:
        single.close()
    rcfg = RefCoVisConfig()
    (padded,) = ref_pack(ev, bucket_lens=(32,))
    (mb,) = list(ref_microbatches(padded, 256))
    mesh = ref_mesh("4x1").mesh
    update = ref_coll.make_sharded_covis_update(ref_coll.pairs_ops.make_plan(rcfg), mesh)
    table = update(ref_coll.make_sharded_table(1 << 14, mesh), jnp.asarray(mb.aid),
                   jnp.asarray(mb.ts), jnp.asarray(mb.type),
                   jnp.zeros_like(jnp.asarray(mb.aid)))
    return port, ref_coll.gather_tagged_table(table, rcfg.names)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_equals_single_device(world, covis_refs, mesh):
    _, out = world
    got = replicated(out, mesh, "covis_update")
    port, ref = covis_refs
    for name in CoVisConfig().names:
        a, b, c = counts_ops.host_finalize(*port[name], 1, 10**9)
        np.testing.assert_array_equal(np.stack(got[name]), np.stack([a, b, c]), err_msg=name)
        np.testing.assert_array_equal(np.stack(got[name]), np.stack(ref[name]), err_msg=name)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_ownership(world, mesh):
    _, out = world
    n = N_DATA[mesh]
    for r in RANKS:
        aid, count = out[r][mesh]["owner"]
        valid = count > 0
        assert valid.any()
        assert np.all((aid[valid] % ranks.pairs_ops.AID_STRIDE) % n
                      == out[r][mesh]["data_rank"])


# ---------------------------------------------------------------------------
# tests/test_pipeline_mesh.py::test_sharded_covis_counter_matches_single
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_covis_counter_matches_single(world, mesh, prune):
    inp, out = world
    cfg = CoVisConfig(**(ranks.PRUNE_COVIS if prune else ranks.COUNTER_COVIS))
    single = CoVisCounter(cfg, CPU, bucket_lens=(8, 32))
    try:
        single.update(Events(**inp["counter_ev"]))
        want = single.finalize()
        pruned = single.ladder.rows_pruned
    finally:
        single.close()
    assert (pruned > 0) == prune
    key = "counter_prune" if prune else "counter"
    for r in RANKS:
        got, _ = out[r][mesh][key]
        for name in cfg.names:
            for g, w in zip(got[name], want[name][:3]):
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    # each pruned row is one shard's: the data ranks' prunes add up to it
    # (each model column of ranks counts the same)
    n_model = 4 // N_DATA[mesh]
    assert sum(out[r][mesh][key][1] for r in RANKS) == pruned * n_model


def single_bounded(inp, kw):
    """One device's bounded counter (host_spill=False) on the counter's
    events -> (finalized tables, retrieval tables, rows it pruned)."""
    single = CoVisCounter(CoVisConfig(**kw), CPU, bucket_lens=(8, 32))
    try:
        single.update(Events(**inp["counter_ev"]))
        rows = {k: int(t.n) for k, t in single.tables.items()}
        want = single.finalize()
        tables = single.retrieval_tables(300)
        top = int(single.ladder.top().n)
    finally:
        single.close()
    return want, tables, rows, top


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_bounded_counter_matches_single(world, mesh):
    """host_spill=False: the shards' bounded tables (otto_tpu's sharded
    form) gathered give one device's bounded table where it does not prune:
    the finalized tables and the dense retrieval tables bit-equal."""
    inp, out = world
    want, tables, rows, top = single_bounded(inp, ranks.BOUNDED_COVIS)
    cap = ranks.BOUNDED_COVIS["accumulator_capacity"]
    assert max(rows.values()) < cap and top == sum(rows.values())   # no prune
    for r in RANKS:
        got, got_tables = out[r][mesh]["counter_bounded"]
        for name in CoVisConfig().names:
            n = int(want[name].n)
            assert len(got[name][0]) == n, name
            for g, w in zip(got[name], want[name][:3]):
                np.testing.assert_array_equal(g, np.asarray(w)[:n], err_msg=name)
            for f, g, w in zip(tables[name]._fields, got_tables[name], tables[name]):
                np.testing.assert_array_equal(g, w.numpy(), err_msg=f"{name}.{f}")


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_bounded_counter_raises_where_one_device_prunes(world, mesh):
    inp, out = world
    _, _, rows, _ = single_bounded(inp, ranks.BOUNDED_FULL_COVIS)
    assert max(rows.values()) == ranks.BOUNDED_FULL_COVIS["accumulator_capacity"]  # pruned
    for r in RANKS:
        msg = out[r][mesh]["counter_bounded_full"]
        assert msg is not None and "would have pruned" in msg


# ---------------------------------------------------------------------------
# tests/test_mesh_stages.py
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def stage_refs(world):
    inp, _ = world
    ev = Events(**inp["emb_ev"])
    packs = pack_sessions(ev, bucket_lens=(8, 32))
    table = inp["emb_table"]
    out = {"emb": compute_session_embeddings(packs, torch.from_numpy(table)),
           "emb_ref": ref_session_emb(ref_pack(ev, bucket_lens=(8, 32)), table,
                                      mesh_ctx=ref_mesh("4x1"))}
    pev = Events(**inp["pop_ev"])
    out["pop"] = compute_popularity(pev, inp["pop_cl"], 5, 300, PopularityConfig(), CPU,
                                    event_budget=1 << 10)
    out["pop_ref"] = ref_popularity(pev, inp["pop_cl"], 5, 300, RefPopularityConfig(),
                                    event_budget=1 << 10, mesh_ctx=ref_mesh("4x1"))
    c = out["corpus"] = inp["knn_corpus"]
    out["knn"] = knn_search(torch.from_numpy(c[:300]), torch.from_numpy(c), 8, "l2",
                            query_block=128)
    out["knn_ref"] = ref_knn(c[:300], c, 8, metric="l2", backend="xla", query_block=128,
                             mesh_ctx=ref_mesh("4x1"))
    return out


@pytest.mark.parametrize("mesh", MESHES)
def test_session_embeddings_sharded_matches_single(world, stage_refs, mesh):
    _, out = world
    s, e = replicated(out, mesh, "session_emb")
    s1, e1 = stage_refs["emb"]
    np.testing.assert_array_equal(s, s1)
    np.testing.assert_array_equal(e, e1.numpy())
    sr, er = stage_refs["emb_ref"]
    np.testing.assert_array_equal(s, sr)
    # one float16 ulp of otto_tpu's (its sums in another order)
    ulp = np.abs(np.spacing(er.astype(np.float16))).astype(np.float32)
    assert np.all(np.abs(e - er) <= ulp)


@pytest.mark.parametrize("mesh", MESHES)
def test_session_embeddings_stacked_f16_close_to_exact(world, mesh):
    """The sharded float16 results within float16 precision of the exact
    float32 batch."""
    inp, out = world
    s, e = replicated(out, mesh, "session_emb")
    for p in pack_sessions(Events(**inp["emb_ev"]), bucket_lens=(8, 32)):
        exact = session_embedding_batch(*(torch.from_numpy(a) for a in (p.aid, p.ts, p.type)),
                                        torch.from_numpy(inp["emb_table"])).numpy()
        rows = np.searchsorted(s, p.session)
        np.testing.assert_allclose(e[rows], exact, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("mesh", MESHES)
def test_popularity_sharded_matches_single(world, stage_refs, mesh):
    _, out = world
    got = replicated(out, mesh, "popularity")
    for g, w, r in zip(got, stage_refs["pop"], stage_refs["pop_ref"]):
        np.testing.assert_array_equal(g, w.numpy())
        np.testing.assert_array_equal(g, np.asarray(r))


@pytest.mark.parametrize("mesh", MESHES)
def test_knn_sharded_matches_single(world, stage_refs, mesh):
    _, out = world
    sc, ix = replicated(out, mesh, "knn")
    np.testing.assert_array_equal(sc, stage_refs["knn"][0].numpy())
    np.testing.assert_array_equal(ix, stage_refs["knn"][1].numpy())
    rs, ri = stage_refs["knn_ref"]
    # a squared distance cancels |q|^2 + |c|^2: within 1e-6 of those terms
    # (tests/test_torch_kmeans.py), the products summed in another order
    c = stage_refs["corpus"]
    terms = 2 * (c * c).sum(1).max()
    np.testing.assert_allclose(sc, rs, rtol=1e-5, atol=1e-6 * terms)
    for r in range(len(ix)):
        assert set(ix[r]) == set(ri[r])


@pytest.fixture(scope="module")
def sgns_refs(world):
    inp, _ = world
    ev = Events(**inp["sgns_ev"])
    cfg = Word2VecConfig(**ranks.SGNS_CFG)
    draws = inp["sgns_draws"]
    ref_ev = generate(SyntheticSpec(n_sessions=400, n_aids=300, mean_len=8, seed=13))
    return {
        "single": train_word2vec_device(ev, cfg, device=CPU).emb,
        "single_ref_draws": train_word2vec_device(
            ev, Word2VecConfig(**ranks.SGNS_REF_CFG), device=CPU, start=inp["sgns_start"],
            draws=lambda e, i: {k: torch.from_numpy(v) for k, v in draws[(e, i)].items()}).emb,
        "ref_mp": {m: ref_w2v.train_word2vec_device(ref_ev, RefW2VConfig(**ranks.SGNS_REF_CFG),
                                                    mesh_ctx=ref_mesh(m)).emb
                   for m in SGNS_MESHES},
    }


@pytest.mark.parametrize("mesh", SGNS_MESHES)
def test_sgns_model_parallel_matches_single(world, sgns_refs, mesh):
    _, out = world
    got = replicated(out, mesh, "sgns")
    np.testing.assert_array_equal(got, sgns_refs["single"])
    got = replicated(out, mesh, "sgns_ref_draws")
    np.testing.assert_array_equal(got, sgns_refs["single_ref_draws"])
    assert {out[r][mesh]["model_rank"] for r in RANKS} == set(range(4 // N_DATA[mesh]))
    np.testing.assert_allclose(got, sgns_refs["ref_mp"][mesh], rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# one case per module: dp k-means, dp GBDT, data-sharded retrieval
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", MESHES)
def test_kmeans_dp_matches_single_and_reference(world, mesh):
    inp, out = world
    n = N_DATA[mesh]
    x, init = inp["km_x"], inp["km_init"][n]
    c, labels, inertia, n_iter = replicated(out, mesh, "kmeans")
    # one device from the same start, bit for bit: exact cluster sums
    want_c, want_l, want_in, want_it = lloyd_fit(torch.from_numpy(x), torch.from_numpy(init))
    np.testing.assert_array_equal(labels, want_l.numpy())
    np.testing.assert_array_equal(c, want_c.numpy())
    assert (inertia, n_iter) == (want_in, want_it)
    ref_c, ref_l, ref_in, ref_it = ref_kmeans.kmeans_fit_dp(
        x, 6, ref_mesh(mesh).mesh, seed=3, init_sample=200)
    np.testing.assert_array_equal(labels, ref_l)
    np.testing.assert_allclose(c, ref_c, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(inertia, ref_in, rtol=1e-5)
    assert n_iter == ref_it
    # the port's own seeding: kmeans_fit's, on any number of ranks
    own_c, own, own_in, own_it = replicated(out, mesh, "kmeans_seeded")
    want_c, want_l, want_in, want_it = kmeans_fit(torch.from_numpy(x), 6, seed=3,
                                                  init_sample=200)
    np.testing.assert_array_equal(own, want_l.numpy())
    np.testing.assert_array_equal(own_c, want_c.numpy())
    assert (own_in, own_it) == (want_in, want_it)
    assert len(np.unique(own)) == 6


@pytest.mark.parametrize("mesh", MESHES)
def test_gbdt_dp_matches_single_and_reference(world, mesh):
    inp, out = world
    n = N_DATA[mesh]
    x, y, sess = inp["gbdt_rows"]
    cfg = GBDTConfig(**ranks.GBDT_CFG)
    names = tuple(f"f{i}" for i in range(x.shape[1]))
    rows_1 = ranks.gbdt_rows(90, 1)
    single = train_gbdt_ranker(
        x, y, sess, names, cfg, valid=inp["gbdt_valid"], device=CPU,
        draws=lambda t: tuple(torch.from_numpy(a[:rows_1] if i else a)
                              for i, a in enumerate(inp["gbdt_bag"][t])))
    gfeat, thr, leaf, gains, evals = replicated(out, mesh, "gbdt")
    np.testing.assert_array_equal(gfeat, single.gfeat)
    np.testing.assert_array_equal(thr, single.thr)
    np.testing.assert_array_equal(leaf, single.leaf)
    np.testing.assert_array_equal(gains, single.gains)
    assert evals == single.eval_history
    # otto_tpu's dp training from its own per-shard draws
    want = ref_gbdt.train_gbdt_ranker(x, y, sess, names, RefGBDTConfig(**ranks.GBDT_CFG),
                                      valid=inp["gbdt_valid"], mesh=ref_mesh(mesh).mesh)
    gfeat, thr, leaf, _, _ = replicated(out, mesh, "gbdt_ref_draws")
    np.testing.assert_array_equal(gfeat, want.gfeat)
    np.testing.assert_array_equal(thr, want.thr)
    np.testing.assert_allclose(leaf, want.leaf, atol=2e-4)


@pytest.mark.parametrize("mesh", MESHES)
def test_gbdt_dp_default_draws_are_one_devices(world, mesh):
    """Without injected draws, dp training takes one device's column
    subsets and row bags (one_device_draws): one device's default
    training, bit for bit."""
    inp, out = world
    x, y, sess = inp["gbdt_rows"]
    single = train_gbdt_ranker(x, y, sess, tuple(f"f{i}" for i in range(x.shape[1])),
                               GBDTConfig(**ranks.GBDT_CFG), valid=inp["gbdt_valid"],
                               device=CPU)
    gfeat, thr, leaf, gains, evals = replicated(out, mesh, "gbdt_default")
    for got, want in ((gfeat, single.gfeat), (thr, single.thr), (leaf, single.leaf),
                      (gains, single.gains)):
        np.testing.assert_array_equal(got, want)
    assert evals == single.eval_history


@pytest.fixture(scope="module")
def retrieval_single(world):
    inp, _ = world
    from otto_tpu_torch import convert

    w = inp["retrieval"]
    ctx = convert.context_from_numpy(w["covis"], w["knn_all"], w["knn_12"], w["pop50"],
                                     w["pop1"], w["aid_emb"], CPU)
    r = Retriever(ctx=ctx, cfg=RetrievalConfig(**ranks.RETRIEVAL_CAPS),
                  sessions=SessionLookup.build(*w["sessions"]))
    keys = label_keys_device(w["labels"], CPU)
    parts = [(b.session, b.cand, b.feats.numpy(), b.pack_meta_labels(keys)[1].numpy())
             for b in r.iter_run(Events(**w["test"]), batch_sessions=w["batch"])]
    return [np.concatenate([p[i] for p in parts]) for i in range(4)]


@pytest.mark.parametrize("mesh", MESHES)
def test_retrieval_sharded_matches_single(world, retrieval_single, mesh):
    from otto_tpu_torch.engine.retrieval import FEATURE_NAMES

    _, out = world
    sess, cand, feats, tbits = replicated(out, mesh, "retrieval")
    want = retrieval_single
    # each rank's shares in rank order: the same sessions, reordered
    order, want_order = np.argsort(sess, kind="stable"), np.argsort(want[0], kind="stable")
    np.testing.assert_array_equal(sess[order], want[0][want_order])
    np.testing.assert_array_equal(cand[order], want[1][want_order])
    np.testing.assert_array_equal(tbits[order], want[3][want_order])
    from test_torch_retrieval import FLOAT_FEATURES

    for i, name in enumerate(FEATURE_NAMES):
        g, w = feats[order][..., i], want[2][want_order][..., i]
        if name in FLOAT_FEATURES:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("mesh", MESHES)
def test_gather_arrays_to_first(world, mesh):
    """gather_arrays_to_first: data rank 0 of each model column gets its
    data group's rows in data-rank order, every other rank None."""
    _, out = world
    for r in RANKS:
        got, n_model = out[r][mesh]["to_first"], 4 // N_DATA[mesh]
        if r // n_model:
            assert got is None
            continue
        want = np.concatenate([np.full((d + 1, 2), 10 * d + r % n_model, np.int16)
                               for d in range(N_DATA[mesh])])
        assert got[0].dtype == np.int16
        np.testing.assert_array_equal(got[0], want)


def test_ranks_and_meshes(world):
    """Row-major layout: rank = data_rank * n_model + model_rank."""
    _, out = world
    for r in RANKS:
        assert out[r]["4x1"]["data_rank"] == r
        assert out[r]["2x2"]["data_rank"] == r // 2
        assert out[r]["1x4"]["model_rank"] == r
        assert out[r]["2x2"]["model_rank"] == r % 2


def test_files_import_no_jax():
    """The rank-side module keeps jax and otto_tpu out of the ranks."""
    src = open(os.path.join(os.path.dirname(__file__), "torch_mesh_ranks.py")).read()
    assert "import jax" not in src and "otto_tpu." not in src.replace("otto_tpu_torch", "")
