"""Rank-side code of tests/test_torch_parallel.py and
tests/test_torch_pipeline_mesh.py.

A spawned rank imports the module that holds its function, so this one
imports torch, numpy and otto_tpu_torch only (never jax or otto_tpu). The
test process writes the inputs (numpy arrays, and otto_tpu's draws where
a case injects them) into `inputs.pkl`; every rank runs every case on
each of its meshes and writes its results to `rank{r}.pkl`.
"""
import os
import pickle
import time

import numpy as np
import torch

from otto_tpu_torch import convert
from otto_tpu_torch.config import (
    CoVisConfig,
    GBDTConfig,
    PopularityConfig,
    RetrievalConfig,
    Word2VecConfig,
)
from otto_tpu_torch.data.batching import iter_microbatches, pack_sessions
from otto_tpu_torch.data.schema import Events
from otto_tpu_torch.engine.covis import ShardedCoVisCounter
from otto_tpu_torch.engine.popularity import compute_popularity
from otto_tpu_torch.engine.retrieval import Retriever, SessionLookup, label_keys_device
from otto_tpu_torch.engine.session_embed import compute_session_embeddings
from otto_tpu_torch.models.gbdt import train_gbdt_ranker
from otto_tpu_torch.models.word2vec import train_word2vec_device
from otto_tpu_torch.ops import pairs as pairs_ops
from otto_tpu_torch.ops.kmeans import kmeans_fit_dp
from otto_tpu_torch.ops.knn import knn_search
from otto_tpu_torch.parallel.collectives import (
    gather_tagged_table,
    make_sharded_covis_update,
    make_sharded_table,
)
from otto_tpu_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")
# the data-sharded meshes, (data, model), and the SGNS ones
DATA_MESHES = ((4, 1), (2, 2))
SGNS_MESHES = ((1, 4), (2, 2))
# settings shared with the test process
SGNS_CFG = dict(name="t", types=(0, 1, 2), vector_size=16, window=4, min_count=1,
                epochs=1, batch_size=512, steps_per_dispatch=4, neg_sharing="chunk",
                knn_k=5, subsample_t=0, block_k=0)
# with otto_tpu's draws: 16 steps of 1024 pairs (at 512 pairs, 32 steps at
# lr 0.25 amplify float32 rounding-order differences past 1e-3, on one
# device as on several)
SGNS_REF_CFG = dict(SGNS_CFG, batch_size=1024)
GBDT_CFG = dict(n_trees=4, max_depth=3, n_bins=16, colsample=0.5, subsample=0.8,
                min_child_samples=5, max_group=16, row_chunk=512, group_chunk=16,
                eval_every=2)
COUNTER_COVIS = dict(pair_budget=1 << 16)
PRUNE_COVIS = dict(pair_budget=1 << 12, max_run_rows=1 << 14, spill_prune_min_rows=64)
# the bounded device table (host_spill=False): large enough that one
# device does not prune, and small enough that it does
BOUNDED_COVIS = dict(pair_budget=1 << 16, host_spill=False, accumulator_capacity=1 << 14)
BOUNDED_FULL_COVIS = dict(BOUNDED_COVIS, accumulator_capacity=1 << 11)
RETRIEVAL_CAPS = dict(max_session_aids=16, max_candidates=64, session_len_buckets=(8, 32))


def gbdt_rows(n_groups: int, n_data: int) -> int:
    """Grouped rows of the GBDT case on n_data ranks: the group count
    padded to group_chunk x n_data, max_group slots each."""
    mult = GBDT_CFG["group_chunk"] * n_data
    return -(-n_groups // mult) * mult * GBDT_CFG["max_group"]


def mesh_name(d: int, m: int) -> str:
    return f"{d}x{m}"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def ev_of(d) -> Events:
    return Events(d["session"], d["aid"], d["ts"], d["type"])


def run_parallel_cases(rank: int, tmp: str) -> None:
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as fh:
        inp = pickle.load(fh)
    out = {}
    for d, m in DATA_MESHES:
        mesh = make_mesh(d, m)
        out[mesh_name(d, m)] = data_cases(mesh, inp)
    for d, m in SGNS_MESHES:
        mesh = make_mesh(d, m)
        res = out.setdefault(mesh_name(d, m), {})
        res["sgns"] = train_word2vec_device(ev_of(inp["sgns_ev"]), Word2VecConfig(**SGNS_CFG),
                                            device=CPU, mesh_ctx=mesh).emb
        draws = inp["sgns_draws"]
        res["sgns_ref_draws"] = train_word2vec_device(
            ev_of(inp["sgns_ev"]), Word2VecConfig(**SGNS_REF_CFG), device=CPU, mesh_ctx=mesh,
            start=inp["sgns_start"],
            draws=lambda e, i: {k: _t(v) for k, v in draws[(e, i)].items()}).emb
        res["model_rank"] = mesh.model_rank
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


def data_cases(mesh, inp) -> dict:
    res = {"data_rank": mesh.data_rank}
    # rows of any count per data rank, received by data rank 0 alone
    res["to_first"] = mesh.gather_arrays_to_first(
        np.full((mesh.data_rank + 1, 2), 10 * mesh.data_rank + mesh.model_rank, np.int16))
    plan = pairs_ops.make_plan(CoVisConfig())

    # collectives: one padded microbatch through the bounded sharded table
    (padded,) = pack_sessions(ev_of(inp["covis_ev"]), bucket_lens=(32,))
    (mb,) = list(iter_microbatches(padded, 256))
    update = make_sharded_covis_update(plan, mesh)
    table, _ = update(make_sharded_table(1 << 14, mesh), _t(mb.aid), _t(mb.ts), _t(mb.type),
                      torch.zeros(mb.aid.shape, dtype=torch.int32))
    res["covis_update"] = gather_tagged_table(table, CoVisConfig().names, mesh)

    (padded,) = pack_sessions(ev_of(inp["owner_ev"]), bucket_lens=(16,))
    (mb,) = list(iter_microbatches(padded, 128))
    table, _ = update(make_sharded_table(1 << 13, mesh), _t(mb.aid), _t(mb.ts), _t(mb.type),
                      torch.zeros(mb.aid.shape, dtype=torch.int32))
    res["owner"] = (table.aid.numpy(), table.count.numpy())

    # the sharded counter, without and with the spill-time prune
    for name, kw in (("counter", COUNTER_COVIS), ("counter_prune", PRUNE_COVIS)):
        cfg = CoVisConfig(**kw)
        counter = ShardedCoVisCounter(cfg, mesh, bucket_lens=(8, 32))
        try:
            counter.update(ev_of(inp["counter_ev"]))
            final = counter.finalize()
            res[name] = ({k: tuple(np.asarray(x) for x in t[:3]) for k, t in final.items()},
                         counter.ladder.rows_pruned)
        finally:
            counter.close()
    # the bounded table: its finalized and retrieval tables where one device
    # does not prune, the error where it does
    counter = ShardedCoVisCounter(CoVisConfig(**BOUNDED_COVIS), mesh, bucket_lens=(8, 32))
    try:
        counter.update(ev_of(inp["counter_ev"]))
        final = counter.finalize()
        res["counter_bounded"] = (
            {k: tuple(np.asarray(x) for x in t[:3]) for k, t in final.items()},
            {k: tuple(x.numpy() for x in t) for k, t in counter.retrieval_tables(300).items()})
    finally:
        counter.close()
    counter = ShardedCoVisCounter(CoVisConfig(**BOUNDED_FULL_COVIS), mesh, bucket_lens=(8, 32))
    try:
        counter.update(ev_of(inp["counter_ev"]))
        counter.finalize()
        res["counter_bounded_full"] = None
    except ValueError as e:
        res["counter_bounded_full"] = str(e)
    finally:
        counter.close()

    # session embeddings, popularity, kNN
    packs = pack_sessions(ev_of(inp["emb_ev"]), bucket_lens=(8, 32))
    s, e = compute_session_embeddings(packs, _t(inp["emb_table"]), mesh_ctx=mesh)
    res["session_emb"] = (s, e.numpy())
    pop = compute_popularity(ev_of(inp["pop_ev"]), inp["pop_cl"], 5, 300, PopularityConfig(),
                             CPU, event_budget=1 << 10, mesh_ctx=mesh)
    res["popularity"] = tuple(x.numpy() for x in pop)
    sc, ix = knn_search(_t(inp["knn_corpus"][:300]), _t(inp["knn_corpus"]), 8, "l2",
                        query_block=128, mesh_ctx=mesh)
    res["knn"] = (sc.numpy(), ix.numpy())

    # k-means: from otto_tpu's per-shard seeding for this data axis, and
    # from the port's own
    x = _t(inp["km_x"])
    for name, init in (("kmeans", _t(inp["km_init"][mesh.n_data])), ("kmeans_seeded", None)):
        c, lab, inertia, n_iter = kmeans_fit_dp(x, 6, mesh, seed=3, init_sample=200,
                                                init=init)
        res[name] = (c.numpy(), lab.numpy(), inertia, n_iter)

    # dp GBDT: the single run's bag split over the ranks, then otto_tpu's
    # per-shard draws
    x, y, sess = inp["gbdt_rows"]
    cfg = GBDTConfig(**GBDT_CFG)
    full = inp["gbdt_bag"]
    share = gbdt_rows(len(np.unique(sess)), mesh.n_data) // mesh.n_data

    def split_bag(t, shard):
        return _t(full[t][0]), _t(full[t][1][shard * share:(shard + 1) * share])

    ref = inp["gbdt_ref_draws"][mesh.n_data]
    for name, draws in (("gbdt", split_bag),
                        ("gbdt_ref_draws", lambda t, shard: (_t(ref[t][0]), _t(ref[t][1][shard])))):
        r = train_gbdt_ranker(x, y, sess, tuple(f"f{i}" for i in range(x.shape[1])), cfg,
                              valid=inp["gbdt_valid"], device=CPU, draws=draws, mesh_ctx=mesh)
        res[name] = (r.gfeat, r.thr, r.leaf, r.gains, r.eval_history)
    r = train_gbdt_ranker(x, y, sess, tuple(f"f{i}" for i in range(x.shape[1])), cfg,
                          valid=inp["gbdt_valid"], device=CPU, mesh_ctx=mesh)
    res["gbdt_default"] = (r.gfeat, r.thr, r.leaf, r.gains, r.eval_history)

    # retrieval: every rank's share of each batch, gathered
    w = inp["retrieval"]
    ctx = convert.context_from_numpy(w["covis"], w["knn_all"], w["knn_12"], w["pop50"],
                                     w["pop1"], w["aid_emb"], CPU)
    retriever = Retriever(ctx=ctx, cfg=RetrievalConfig(**RETRIEVAL_CAPS),
                          sessions=SessionLookup.build(*w["sessions"]), mesh=mesh)
    keys = label_keys_device(w["labels"], CPU)
    parts = []
    for b in retriever.iter_run(ev_of(w["test"]), batch_sessions=w["batch"]):
        _, tbits = b.pack_meta_labels(keys)
        parts.append((b.session, b.cand, b.feats.numpy(), tbits.numpy()))
    res["retrieval"] = mesh.gather_arrays(*(np.concatenate([p[i] for p in parts])
                                            for i in range(4)))
    return res


def pipeline_cfg():
    """tests/test_pipeline_mesh.py's configuration, in the port's classes."""
    import dataclasses

    from otto_tpu_torch.config import Config, KMeansConfig, RankerConfig

    wall = Word2VecConfig(name="wall", types=(0, 1, 2), vector_size=16, window=4,
                          min_count=2, epochs=2, batch_size=4096, knn_k=10,
                          knn_first_n_aids=800)
    # a smaller pair budget than the reference's (4M lanes a microbatch):
    # the same counts, in less CPU time
    return Config(
        covis=dataclasses.replace(CoVisConfig(), accumulator_capacity=1 << 17,
                                  pair_budget=1 << 16),
        retrieval=RetrievalConfig(max_session_aids=16, max_candidates=128,
                                  session_len_buckets=(8, 32)),
        w2vec={"wall": wall, "w12": dataclasses.replace(wall, name="w12", types=(1, 2),
                                                        epochs=1)},
        kmeans=dataclasses.replace(KMeansConfig(), max_iter=10),
        ranker=RankerConfig(hidden_dims=(32, 16), epochs=2, batch_sessions=64, max_group=64),
        gbdt=GBDTConfig(n_trees=10, max_depth=3, n_bins=16, colsample=0.5, subsample=0.8,
                        min_child_samples=5, max_group=64, row_chunk=4096, group_chunk=64),
    )


# what the batch runner's work dir is seeded with: the table artifacts of
# a finished run (config and meta included)
TABLE_FILES = ("covis.pkl", "w2v-wall.npz", "w2v-w12.npz", "knn-wall.npz", "knn-w12.npz",
               "session_emb.npz", "clusters.npz", "config.json", "meta.json")
# pass A's cases: (data ranks, device_select)
PASS_A_CASES = ((4, False), (4, True), (2, False), (2, True))
PASS_A_BATCH = 48


def seed_tables(src: str, dst: str) -> None:
    """A fresh work dir holding src's table artifacts."""
    import shutil

    os.makedirs(dst, exist_ok=True)
    for name in TABLE_FILES:
        shutil.copyfile(os.path.join(src, name), os.path.join(dst, name))


def pass_a_dir(tmp: str, n_data: int, device_select: bool) -> str:
    return os.path.join(tmp, f"passA-{n_data}-{'device' if device_select else 'numpy'}")


def run_pass_a(tmp: str, inp, n_data: int, device_select: bool, mesh=None) -> dict:
    """pass_a over the retriever of tmp/one-or-four's cache (on `mesh`, or
    on one device) into pass_a_dir(...); -> its metrics."""
    import dataclasses

    import torch.distributed as dist

    from otto_tpu_torch.data.schema import Labels
    from otto_tpu_torch.pipeline.runner import build_retriever, pass_a

    cfg = pipeline_cfg()
    out = pass_a_dir(tmp, n_data, device_select)
    if mesh is None or mesh.is_main:
        os.makedirs(out, exist_ok=True)
    retriever, _ = build_retriever(
        ev_of(inp["train"]), ev_of(inp["test"]), 600, CPU, cfg.w2vec, None, cfg.covis,
        cfg.popularity, cfg.retrieval, cfg.kmeans,
        cache_dir=os.path.join(tmp, "four" if mesh is not None else "one"), mesh=mesh)
    metrics, _ = pass_a(retriever, ev_of(inp["test"]), Labels(*inp["labels"]),
                        dataclasses.replace(cfg.ranker, device_select=device_select), out,
                        batch_sessions=PASS_A_BATCH)
    if mesh is not None:
        dist.barrier()
    return metrics


def run_pipeline(rank: int, tmp: str) -> None:
    """On data=4: Pipeline(mesh=).run_streaming on the test process's split
    in tmp/four; pass_a on data=4 and data=2 (a 2x2 mesh) from that cache,
    both selection paths; then the batch runner Pipeline(mesh=).run in
    tmp/four-batch, seeded with tmp/four's tables, with labels and then
    inference-only (its first submission's bytes kept)."""
    import torch.distributed as dist

    from otto_tpu_torch.data.schema import Labels
    from otto_tpu_torch.pipeline.runner import Pipeline

    with open(os.path.join(tmp, "inputs.pkl"), "rb") as fh:
        inp = pickle.load(fh)
    train, test, labels = ev_of(inp["train"]), ev_of(inp["test"]), Labels(*inp["labels"])
    mesh = make_mesh(4, 1)
    out = {}
    pipe = Pipeline(cfg=pipeline_cfg(), work_dir=os.path.join(tmp, "four"), n_aids=600,
                    device="cpu", mesh=mesh)
    out["streaming"] = pipe.run_streaming(train, test, labels, batch_sessions=64)
    meshes = {4: mesh, 2: make_mesh(2, 2)}
    out["pass_a"] = {case: run_pass_a(tmp, inp, case[0], case[1], meshes[case[0]])
                     for case in PASS_A_CASES}
    batch_dir = os.path.join(tmp, "four-batch")
    if mesh.is_main:
        seed_tables(os.path.join(tmp, "four"), batch_dir)
    dist.barrier()
    pipe = Pipeline(cfg=pipeline_cfg(), work_dir=batch_dir, n_aids=600, device="cpu",
                    mesh=mesh)
    out["batch"] = pipe.run(train, test, labels, batch_sessions=64)
    with open(os.path.join(batch_dir, "submission.csv"), "rb") as fh:
        out["submission"] = fh.read()
    dist.barrier()   # every rank has read it before the rerun writes it
    out["inference"] = pipe.run(train, test, None, batch_sessions=64)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


def fail_on_rank_one(rank: int, tmp: str) -> None:
    """A mesh larger than the world raises; then rank 1 dies."""
    import torch.distributed as dist

    try:
        make_mesh(4, 1)
        msg = None
    except ValueError as e:
        msg = str(e)
    with open(os.path.join(tmp, f"rank{rank}.txt"), "w") as fh:
        fh.write(msg or "")
    dist.barrier()
    if rank == 1:
        raise RuntimeError("rank 1 dies")
    time.sleep(30)   # rank 0 outlives rank 1, whose failure ends the run
