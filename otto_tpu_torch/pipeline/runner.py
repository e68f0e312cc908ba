"""The ported pipeline.

Counterpart of otto_tpu/pipeline/runner.py. The stages are module
functions:

- `build_retriever`: co-visitation counting (C7), word2vec training
  (C8), the item kNN tables (C9), the session embeddings (C10), the
  session clusters (C11) and cluster popularity (C12) on the device, and
  the Retriever that serves from them; with a cache dir, each artifact is
  read from there when present and written there when built, in
  otto_tpu's formats, so either package reads the other's work dir;
- `pass_a`: retrieve the test sessions with labels: the label join, the
  per-source retrieval eval (C14) and negative downsampling (C15), whose
  rows are persisted per target before any training;
- `train_ranker_cached`: one target's ranker (C16) from those rows, as
  `RANKER_BACKENDS` says for `Config.ranker_backend` (a backend without
  a trainer there, "hstu" or "mla_moe", is served from its saved file and
  never trained here);
- `score_pass`: re-retrieve the test sessions, score every batch with the
  three target rankers on the device, keep the top-20 per target;
- `submit_and_eval`: write the submission file and evaluate recall@20;
- `run_streaming`: all of them in that order, with otto_tpu's work-dir
  guard (`check_work_dir`) and crash-resume fast path.

`pass_a` and `score_pass` overlap each batch's consumer work with the
next batch's retrieval (`pipelined_consume`).

Every stage takes an optional `mesh` (parallel.mesh.MeshContext): one
process per rank, every rank calling with the same events, as otto_tpu's
Pipeline(mesh=...) runs its stages sharded. Work otto_tpu's controller
does once on the host runs on every rank from replicated data: the
co-visitation prune and tables, the popularity ladder, the k-means
seeding, the rankers' rows and the metrics. Only rank 0 writes files, in
the formats and with the bytes of a one-rank run; the other ranks read
the artifact cache as it stood when the stage began. `Pipeline` is otto_tpu's
class over a work dir: its streaming runner calls `run_streaming`, and
its batch runner (`run`) keeps every retrieval batch on the device (with
a mesh, each data rank its own), with the host-side C14 eval.
`run_synthetic` runs it on generated sessions.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import pickle
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from otto_tpu_torch.config import (
    KEEP_TOP_K,
    TYPE2ID,
    TYPES,
    W2VEC_MODELS,
    Config,
    CoVisConfig,
    KMeansConfig,
    PopularityConfig,
    RankerConfig,
    RetrievalConfig,
    Word2VecConfig,
    config_to_json,
    stale_sections,
)
from otto_tpu_torch.data.batching import pack_sessions
from otto_tpu_torch.data.schema import Events, Labels
from otto_tpu_torch.data.split import split_events
from otto_tpu_torch.data.synthetic import SyntheticSpec, generate
from otto_tpu_torch.device import resolve
from otto_tpu_torch.engine import rank as rank_engine
from otto_tpu_torch.engine.covis import CoVisCounter, CoVisTables, ShardedCoVisCounter
from otto_tpu_torch.engine.popularity import compute_popularity
from otto_tpu_torch.engine.retrieval import (
    FEATURE_NAMES,
    HostCopy,
    RetrievalContext,
    Retriever,
    SessionLookup,
    join_labels,
    label_keys_device,
)
from otto_tpu_torch.engine.session_embed import (
    KnnTables,
    build_knn_tables,
    compute_session_embeddings,
)
from otto_tpu_torch.eval.diagnostics import w2vec_covis_overlap, write_overlap_report
from otto_tpu_torch.eval.per_source import (
    DeviceSourceEval,
    SrcFlagBatch,
    eval_retrieved_by_source,
    format_report,
)
from otto_tpu_torch.eval.recall import evaluate_submission_file, evaluate_topk, recall_at_k
from otto_tpu_torch.models.gbdt import GBDTRanker, train_gbdt_ranker
from otto_tpu_torch.models.hstu import HSTURanker
from otto_tpu_torch.models.mla_moe import MLAMoERanker
from otto_tpu_torch.models.ranker import Ranker, train_ranker
from otto_tpu_torch.models.word2vec import Word2Vec, train_word2vec, train_word2vec_device
from otto_tpu_torch.ops import counts as counts_ops
from otto_tpu_torch.ops.kmeans import kmeans_fit, kmeans_fit_dp
from otto_tpu_torch.utils import timing
from otto_tpu_torch.utils.reports import report_name

log = logging.getLogger(__name__)

# stage(name, msg, peak_bytes): called as each of otto_tpu's stages ends,
# with otto_tpu's stage name; peak_bytes is the stage's peak device memory
# where the caller measured it, else None (Pipeline keeps them as its
# stage_log)
StageFn = Callable[[str, str, Optional[int]], None]


def _no_stage(name: str, msg: str = "", peak_bytes: Optional[int] = None) -> None:
    pass


@dataclasses.dataclass
class BuildReport:
    """What `build_retriever` measured: seconds per stage (ended by a device
    sync; "covis count" is both updates, "covis tables" the global merge,
    prune and top-N tables, "w2vec {name}" a model's training, "load
    {file}" / "write {file}" an artifact read from / written to the
    cache), on CUDA the peak bytes allocated within each stage, the co-visitation
    counter's work (`covis`: seconds of host dedup and packing,
    microbatches, grid lanes, emitted pairs, ladder merges, rows spilled
    and pruned, the host merge that ran, unique pairs per type before /
    after the global prune, rows with a neighbour per table), what each
    trained word2vec model ran (`w2vec`), the w2vec x co-visitation
    overlap per model, the k-means fit (inertia, n_iter, n_points,
    n_nonempty clusters), the popularity tables' fill (`popularity`:
    candidates per cluster, aids ranked) and the artifact cache (`cache`:
    the artifacts read and written, the seconds spent writing, the bytes
    of every artifact in the cache dir; empty without one). A stage read
    from the cache has no counter, training or fit entry."""

    seconds: Dict[str, float]
    peak_bytes: Dict[str, int]
    covis: Dict[str, object]
    w2vec: Dict[str, object]
    overlap: Dict[str, Dict[str, float]]
    kmeans: Dict[str, float]
    popularity: Dict[str, object]
    cache: Dict[str, object] = dataclasses.field(default_factory=dict)


# the artifact cache of build_retriever, in otto_tpu's names and formats
# (model names fill the {} of the per-model files)
CACHE_FILES = ("covis.pkl", "w2v-{}.npz", "knn-{}.npz", "session_emb.npz",
               "clusters.npz", "kmeans-inertia.csv")


def _covis_report(counter: CoVisCounter, tables) -> Dict[str, object]:
    ladder = counter.ladder
    return {
        "host_seconds": counter.host_seconds,
        "microbatches": counter.n_microbatches,
        "lanes": counter.n_lanes,
        "pairs": counter.pairs_emitted,
        "ladder_merges": ladder.n_merges,
        "rows_spilled": ladder.rows_spilled,
        "rows_pruned": ladder.rows_pruned,
        "host_merge": counts_ops.host_merge_kind() if counter.spill else None,
        "unique_pairs": dict(counter.unique_pairs),
        "rows_with_neighbours": {
            name: int((t.neighbor[:, 0] >= 0).sum()) for name, t in tables.items()},
    }


def _popularity_report(pop) -> Dict[str, object]:
    per_cluster = (pop.candidate >= 0).sum(dim=1)
    return {
        "clusters": int(pop.candidate.shape[0]),
        "candidates_min": int(per_cluster.min()),
        "candidates_max": int(per_cluster.max()),
        "candidates_total": int(per_cluster.sum()),
        "aids_ranked": int((pop.aid_rank.amin(dim=1) < 999).sum()),
    }


def _event_clusters(session: np.ndarray, sess_ids: np.ndarray,
                   labels: np.ndarray) -> np.ndarray:
    """Each event's session cluster (0 for a session without one);
    `sess_ids` sorted ascending, `labels` aligned with it."""
    pos = np.clip(np.searchsorted(sess_ids, session), 0, len(sess_ids) - 1)
    hit = sess_ids[pos] == session
    return np.where(hit, np.asarray(labels, np.int32)[pos], 0).astype(np.int32)


def build_retriever(
    train: Events,
    test: Events,
    n_aids: int,
    device,
    w2vec: Dict[str, Word2VecConfig] = W2VEC_MODELS,
    models: Optional[Dict[str, Word2Vec]] = None,
    covis: CoVisConfig = CoVisConfig(),
    popularity: PopularityConfig = PopularityConfig(),
    retrieval: RetrievalConfig = RetrievalConfig(),
    kmeans: KMeansConfig = KMeansConfig(),
    report_dir: Optional[str] = None,
    cache_dir: Optional[str] = None,
    use_cache: bool = True,
    mesh=None,
    stage: StageFn = _no_stage,
) -> Tuple[Retriever, BuildReport]:
    """Stages C7-C12 and the retrieval context, on `device`, as otto_tpu's
    Pipeline.build_retriever runs them:
      C7  a CoVisCounter over train, then over test, and its retrieval
          tables (five, in `covis.names` order);
      C8  the word2vec models of `w2vec` that `models` does not hold,
          trained on train + test (`sampler` picks train_word2vec_device
          or train_word2vec); a given model keeps its own cfg;
      C9  `build_knn_tables` for each model (K3), then each model's overlap
          with the click-to-click co-visitation neighbours (logged;
          written as `stats_w2vec_x_co_click-{name}.csv` into `report_dir`
          if given);
      C10 `compute_session_embeddings` over every session of train + test
          with the main model's table (K4);
      C11 `kmeans_fit` with `n_clusters_to_find[0]` clusters;
      C12 `compute_popularity` of train + test over those clusters and
          over one cluster.
    Models go by `w2vec`'s names, in its order: the first is the main model
    (the item embeddings and knn_all), the second gives knn_1_2.

    `stage(name, msg, peak_bytes)` is called as each of otto_tpu's stages
    ends, with otto_tpu's names: "covis", "w2vec {name}" (a model and its
    kNN tables), "session_emb", "kmeans", "popularity", "context built";
    `peak_bytes` is the stage's peak device memory on CUDA, else None.

    With `cache_dir`, C7-C11 each read their artifact from there when it is
    present and use_cache, else build it and write it there: `covis.pkl`
    (a dict of tuples of numpy arrays), `w2v-{name}.npz` (not for a given
    model), `knn-{name}.npz`, `session_emb.npz`, `clusters.npz` (and a row
    of `kmeans-inertia.csv`), in otto_tpu's formats. A device-sampled
    word2vec training then keeps its epoch checkpoint in
    `w2v-{name}.ckpt` (resumed from when present), removed once the .npz
    is written. Popularity is recomputed every time, as in otto_tpu.

    With `mesh`, otto_tpu's mesh branches: C7 a ShardedCoVisCounter (data
    axis > 1), C8 model-parallel SGNS (model axis > 1; no checkpoint), C9
    and C10 split their rows over the data ranks, C11 kmeans_fit_dp (data
    axis > 1), C12 the sharded popularity emission, and the Retriever
    retrieves each rank's share of a batch. Every rank returns the same
    tables; rank 0 alone writes the cache and the reports.
    -> (Retriever, BuildReport)."""
    check_mesh_device(device, mesh)
    dev = torch.device(device)
    names = list(w2vec)
    models = dict(models or {})
    if len(names) < 2:
        raise ValueError(f"build_retriever: two w2vec models, got {names}")
    unknown = sorted(set(models) - set(names))
    if unknown:
        raise ValueError(f"build_retriever: models {unknown} are not in w2vec {names}")
    main = mesh is None or mesh.is_main
    n_data = 1 if mesh is None else mesh.n_data
    if mesh is not None:
        dist.barrier()
    # the cache as it stands now: later writes (rank 0's) are not read back;
    # a link to a file not written yet (scripts/run_fullscale_torch.py's
    # OTTO_FS_TMPFS) is no artifact, and the writer fills its target
    present = ({f for f in os.listdir(cache_dir) if os.path.exists(os.path.join(cache_dir, f))}
               if cache_dir is not None and use_cache and os.path.isdir(cache_dir) else set())
    loaded: List[str] = []
    written: List[str] = []
    seconds: Dict[str, float] = {}
    peak: Dict[str, int] = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    stage_peak = 0   # the peak of the laps since the last stage ended

    def lap(name):
        nonlocal t, stage_peak
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            peak[name] = torch.cuda.max_memory_allocated(dev)
            stage_peak = max(stage_peak, peak[name])
            torch.cuda.reset_peak_memory_stats(dev)
        now = time.perf_counter()
        seconds[name] = now - t
        t = now

    def end(name, msg=""):
        """otto_tpu's stage `name` has ended."""
        nonlocal stage_peak
        stage(name, msg, stage_peak if dev.type == "cuda" else None)
        stage_peak = 0

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def cached(name: str) -> Optional[str]:
        """The artifact's path when the cache holds it (and is used)."""
        if name in present:
            loaded.append(name)
            return os.path.join(cache_dir, name)
        return None

    def save(name: str, write: Callable[[str], None]) -> None:
        """write(path) the artifact into the cache (rank 0), timed as
        "write {name}"."""
        if cache_dir is not None and main:
            write(os.path.join(cache_dir, name))
            written.append(name)
            lap(f"write {name}")

    # ---- C7 co-visitation --------------------------------------------------
    path = cached("covis.pkl")
    if path:
        with open(path, "rb") as fh:
            stored = pickle.load(fh)
        tables = {name: CoVisTables(*(put(a) for a in stored[name])) for name in covis.names}
        covis_rep = {"cached": "covis.pkl"}
        lap("load covis.pkl")
    else:
        counter = (ShardedCoVisCounter(covis, mesh) if n_data > 1
                   else CoVisCounter(covis, dev))
        try:
            counter.update(train)
            counter.update(test)
            lap("covis count")
            tables = counter.retrieval_tables(n_aids)
        finally:
            counter.close()
        covis_rep = _covis_report(counter, tables)
        log.info("covis %s", covis_rep)
        lap("covis tables")
        save("covis.pkl", lambda p: _pickle(p, {k: tuple(x.cpu().numpy() for x in v)
                                                for k, v in tables.items()}))
    covis_tables = tuple(tables[name] for name in covis.names)
    end("covis")

    # ---- C8 word2vec, C9 kNN (a model, then its tables) -------------------
    full = train.concat(test)
    trained = {}
    knns = {}
    for name in names:
        wcfg = w2vec[name]
        mfile = f"w2v-{name}.npz"
        path = None if name in models else cached(mfile)
        if path:
            models[name] = Word2Vec.load(path, wcfg)
            lap(f"load {mfile}")
        elif name not in models:
            ckpt = (os.path.join(cache_dir, f"w2v-{name}.ckpt")
                    if cache_dir is not None and use_cache and wcfg.sampler == "device"
                    and mesh is None else None)
            if wcfg.sampler == "device":
                models[name] = train_word2vec_device(full, wcfg, n_aids, device=dev,
                                                     checkpoint_path=ckpt, mesh_ctx=mesh)
            else:
                models[name] = train_word2vec(full, wcfg, n_aids, device=dev)
            trained[name] = models[name].report
            log.info("w2vec %s: %s", name, trained[name])
            lap(f"w2vec {name}")
            save(mfile, models[name].save)
            # the checkpoint goes only once the .npz is written: no moment
            # without either
            if ckpt and os.path.exists(ckpt):
                os.remove(ckpt)
        kfile = f"knn-{name}.npz"
        path = cached(kfile)
        if path:
            z = np.load(path)
            knns[name] = KnnTables(put(z["neighbor"]), put(z["dist"]))
            lap(f"load {kfile}")
        else:
            knns[name] = build_knn_tables(models[name], n_aids, dev, mesh_ctx=mesh)
            lap(f"knn {name}")
            kt = knns[name]
            save(kfile, lambda p: np.savez_compressed(p, neighbor=kt.neighbor.cpu().numpy(),
                                                      dist=kt.dist.cpu().numpy()))
        end(f"w2vec {name}")
    co_nbr = tables["click_to_click"].neighbor.cpu().numpy()
    overlap = {}
    for name in names:
        overlap[name] = w2vec_covis_overlap(knns[name].neighbor.cpu().numpy(), co_nbr)
        log.info("w2vec overlap %s: %s", name, overlap[name])
        if report_dir is not None and main:
            write_overlap_report(
                os.path.join(report_dir, f"stats_w2vec_x_co_click-{name}.csv"),
                overlap[name])
    lap("overlap")

    # ---- C10 session embeddings --------------------------------------------
    aid_emb = put(models[names[0]].embedding_by_aid(n_aids))
    path = cached("session_emb.npz")
    if path:
        z = np.load(path)
        sess_ids, sess_emb = z["session"], put(z["emb"])
        lap("load session_emb.npz")
    else:
        sess_ids, sess_emb = compute_session_embeddings(pack_sessions(full), aid_emb,
                                                        mesh_ctx=mesh)
        lap("session_emb")
        # uncompressed: the [n_sessions, D] grid is large
        save("session_emb.npz",
             lambda p: np.savez(p, session=sess_ids, emb=sess_emb.cpu().numpy()))
    end("session_emb")

    # ---- C11 kmeans --------------------------------------------------------
    n_clusters = kmeans.n_clusters_to_find[0]
    km = {}
    path = cached("clusters.npz")
    if path:
        labels = np.load(path)["cluster"]
        lap("load clusters.npz")
    else:
        if n_data > 1:
            _, labels, inertia, n_iter = kmeans_fit_dp(
                sess_emb, n_clusters, mesh, max_iter=kmeans.max_iter, tol=kmeans.tol,
                seed=kmeans.seed)
        else:
            _, labels, inertia, n_iter = kmeans_fit(
                sess_emb, n_clusters, max_iter=kmeans.max_iter, tol=kmeans.tol,
                seed=kmeans.seed)
        labels = labels.cpu().numpy()
        km = {"inertia": inertia, "n_iter": n_iter, "n_points": len(labels),
              "n_nonempty": int(np.unique(labels).size)}
        log.info("kmeans %s", km)
        lap("kmeans")
        save("clusters.npz", lambda p: np.savez_compressed(p, session=sess_ids, cluster=labels))
        if cache_dir is not None and main:
            with open(os.path.join(cache_dir, "kmeans-inertia.csv"), "a") as fh:
                if fh.tell() == 0:
                    fh.write("n_clusters,inertia,n_iter,n_points\n")
                fh.write(f"{n_clusters},{inertia:.3f},{n_iter},{len(labels)}\n")
    end("kmeans")

    # ---- C12 popularity ----------------------------------------------------
    pop50 = compute_popularity(
        full, _event_clusters(full.session, sess_ids, labels), n_clusters,
        n_aids, popularity, dev, mesh_ctx=mesh)
    pop1 = compute_popularity(
        full, np.zeros(len(full), np.int32), 1, n_aids, popularity, dev, mesh_ctx=mesh)
    pop_rep = {"cl50": _popularity_report(pop50), "cl1": _popularity_report(pop1)}
    log.info("popularity %s", pop_rep)
    lap("popularity")
    end("popularity")

    ctx = RetrievalContext(
        covis=covis_tables,
        knn_all=tuple(knns[names[0]]),
        knn_1_2=tuple(knns[names[1]]),
        pop_cl50_cand=pop50.candidate,
        pop_cl50_ranks=pop50.ranks,
        pop_cl1_rank=pop1.aid_rank,
        aid_emb=aid_emb,
    )
    retriever = Retriever(
        ctx=ctx, cfg=retrieval,
        sessions=SessionLookup.build(sess_ids, labels, sess_emb.cpu().numpy()),
        mesh=mesh,
    )
    lap("context")
    cache = {}
    if cache_dir is not None:
        files = [os.path.join(cache_dir, f.format(n))
                 for f in CACHE_FILES for n in (names if "{}" in f else [None])]
        if mesh is not None:
            dist.barrier()   # rank 0's writes are on disk
        cache = {"loaded": loaded, "written": written,
                 "write_seconds": sum(seconds[f"write {n}"] for n in written),
                 "bytes": sum(os.path.getsize(f) for f in files if os.path.exists(f))}
        log.info("artifact cache %s: %s", cache_dir, cache)
    end("context built", f"cache: loaded {loaded}, wrote {written}" if cache else "")
    return retriever, BuildReport(seconds, peak, covis_rep, trained, overlap, km, pop_rep,
                                  cache)


def _pickle(path: str, obj) -> None:
    with open(path, "wb") as fh:
        pickle.dump(obj, fh)


def check_serving_features(tname: str, ranker) -> None:
    """A ranker scores retrieval's [S, C, F] features only if it was trained
    on FEATURE_NAMES, in that order."""
    if tuple(ranker.feature_names) != FEATURE_NAMES:
        raise ValueError(
            f"ranker '{tname}' was trained on {len(ranker.feature_names)} other "
            f"features, not retrieval's {len(FEATURE_NAMES)} FEATURE_NAMES")


def score_pass(
    retriever: Retriever, test: Events, rankers: Dict[str, object],
    batch_sessions: int, overlap: bool = True,
) -> Dict[str, tuple]:
    """One scoring pass: retrieve, score all three targets per batch on the
    device, pull one stacked [3, S, 20] aid array per batch; with
    `overlap`, a batch is scored and pulled while the next one retrieves
    (pipelined_consume). With the retriever's mesh, each data rank scores
    its own batches and the top-20s are gathered to every rank.
    -> {type name: (sessions [N] sorted, top-20 aids [N, 20])}."""
    for tname in TYPES:
        check_serving_features(tname, rankers[tname])
    parts = []
    ranker_list = [rankers[t] for t in TYPES]

    def consume(b, meta):
        parts.append((b.session, rank_engine.score_topk_multi(b, ranker_list)))

    # the request's spans give pipelined_consume's seconds: "produce" is
    # retrieval.pack + retrieval.batch, "consume" runner.consume, "wait"
    # runner.put_wait + runner.join
    with timing.request("otto::runner.score_pass"):
        pipelined_consume(retriever.iter_run(test, batch_sessions=batch_sessions), consume,
                          overlap=overlap)
        with timing.span("otto::runner.assemble"):
            return assemble_preds(parts, getattr(retriever, "mesh", None))


def assemble_preds(parts: list, mesh=None) -> Dict[str, tuple]:
    """Each target's (sessions [N] sorted, top-20 aids [N, 20]) from the
    (sessions [S], score_topk_multi's [3, S, 20] aids) of every batch
    scored, in batch order: concatenated, with `mesh` gathered from every
    data rank, then stably sorted by session."""
    sessions = _cat_rows([p[0] for p in parts], (0,), np.int32)
    preds = {}
    for i, tname in enumerate(TYPES):
        s, a = sessions, _cat_rows([p[1][i] for p in parts], (0, KEEP_TOP_K), np.int32)
        if mesh is not None:
            s, a = mesh.gather_arrays(s.astype(np.int32), a.astype(np.int32))
        order = np.argsort(s, kind="stable")
        preds[tname] = (s[order], a[order])
    return preds


def _cat_rows(parts: list, empty_shape, dtype) -> np.ndarray:
    """np.concatenate, or an empty array for a rank that had no batch."""
    return np.concatenate(parts) if parts else np.zeros(empty_shape, dtype)


def pipelined_consume(batch_iter, consume, pack=None, overlap: bool = True
                      ) -> Dict[str, float]:
    """Producer / consumer over retrieval batches (otto_tpu's
    `_pipelined_consume`). The calling thread retrieves each batch and runs
    `pack(b)` (its device programs, and the start of their host copies);
    `consume(b, pack(b))` does the batch's host work.

    With `overlap`, consume runs on a worker thread, one batch behind,
    through a queue of depth 1 (at most ~3 batches' features alive), so a
    batch's host work overlaps the next batch's retrieval. On CUDA the
    worker sets the batch's device and runs consume on a stream of its own:
    that stream first waits for an event the producer recorded after
    pack(b), and the batch's device tensors are marked as used there
    (record_stream), so the consumer's device work and pulls never wait for
    the producer's later batches, and no tensor is reused under it. After
    a consumer error the worker drains the queue (the producer never
    blocks) and the error is raised here. Without `overlap`, the same
    calls run in turn on this thread.

    -> seconds: "produce" (retrieval and pack, on this thread), "consume"
    (the consumer's own time), "wait" (this thread blocked on the queue
    or on the worker's last batches)."""
    seconds = {"produce": 0.0, "consume": 0.0, "wait": 0.0}
    if not overlap:
        t = time.perf_counter()
        for b in batch_iter:
            meta = pack(b) if pack is not None else None
            t1 = time.perf_counter()
            with timing.span("otto::runner.consume", getattr(b, "index", None)):
                consume(b, meta)
            t2 = time.perf_counter()
            seconds["produce"] += t1 - t
            seconds["consume"] += t2 - t1
            t = time.perf_counter()
        return seconds

    q: "queue.Queue" = queue.Queue(maxsize=1)
    errs: list = []
    req = timing.current_request()

    def drain():
        # the consumer's spans: runner.consumer, the thread's life, split
        # into runner.get_wait and runner.consume
        with timing.joined(req), timing.span("otto::runner.consumer"):
            stream = None
            while True:
                with timing.span("otto::runner.get_wait"):
                    item = q.get()
                if item is None:
                    return
                if errs:
                    continue   # discard: the producer's put() must never block
                b, meta, ready = item
                t = time.perf_counter()
                try:
                    with timing.span("otto::runner.consume", getattr(b, "index", None)):
                        if ready is None:
                            consume(b, meta)
                        else:
                            dev = b.feats.device
                            if stream is None:
                                torch.cuda.set_device(dev)
                                stream = torch.cuda.Stream(dev)
                            stream.wait_event(ready)
                            for x in b.device_tensors():
                                x.record_stream(stream)
                            with torch.cuda.stream(stream):
                                consume(b, meta)
                except BaseException as e:   # re-raised in the producer
                    errs.append(e)
                seconds["consume"] += time.perf_counter() - t

    worker = threading.Thread(target=drain, daemon=True, name="pipeline-consume")
    worker.start()
    try:
        t = time.perf_counter()
        for b in batch_iter:
            if errs:
                break
            meta = pack(b) if pack is not None else None
            ready = None
            if b.feats.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(b.feats.device))
            t1 = time.perf_counter()
            with timing.span("otto::runner.put_wait", getattr(b, "index", None)):
                q.put((b, meta, ready))
            t2 = time.perf_counter()
            seconds["produce"] += t1 - t
            seconds["wait"] += t2 - t1
            t = time.perf_counter()
    finally:
        t = time.perf_counter()
        with timing.span("otto::runner.join"):
            q.put(None)
            worker.join()
        seconds["wait"] += time.perf_counter() - t
    if errs:
        raise errs[0]
    return seconds


def submit_and_eval(
    work_dir: str, preds: Dict[str, tuple], labels: Optional[Labels],
    stage: StageFn = _no_stage,
) -> Optional[Dict[str, float]]:
    """Write `submission.csv` into work_dir; with labels, evaluate recall@20
    (written to `eval_submission.json` and to a timestamped, git-hashed
    copy `eval-submission-*.json`) and cross-check it against an
    independent re-parse of the CSV (evaluate_submission_file), logging a
    warning when they differ. `stage` (StageFn) hears "submit" once the
    CSV is written and "eval" once recall@20 is. -> the recall dict, or
    None without labels."""
    path = os.path.join(work_dir, "submission.csv")
    rank_engine.write_submission(path, preds)
    stage("submit", "", None)
    if labels is None:
        return None
    res = evaluate_topk(preds, labels)
    for name in ("eval_submission.json", report_name("eval-submission") + ".json"):
        with open(os.path.join(work_dir, name), "w") as fh:
            json.dump(res, fh, indent=2)
    stage("eval", json.dumps(res), None)
    res2 = evaluate_submission_file(path, labels)
    if abs(res2["total"] - res["total"]) > 1e-9:
        log.warning("submission re-parse mismatch: %s vs %s",
                    res2["total"], res["total"])
    return res


def _submit_on_main(work_dir: str, preds, labels: Optional[Labels], mesh,
                    stage: StageFn = _no_stage):
    """submit_and_eval on rank 0, its result broadcast to every rank (the
    other ranks hear its stages once it is)."""
    if mesh is None:
        return submit_and_eval(work_dir, preds, labels, stage)
    res = [submit_and_eval(work_dir, preds, labels, stage) if mesh.is_main else None]
    dist.broadcast_object_list(res, src=0)
    if not mesh.is_main:
        stage("submit", "", None)
        if res[0] is not None:
            stage("eval", json.dumps(res[0]), None)
    return res[0]


def _train_gbdt(work_dir, tname, feats, y, sess, valid, cfg: Config, device, mesh):
    """train_gbdt_ranker with cfg.gbdt, data-parallel over the mesh's data
    ranks; rank 0 writes its gain importance (`feat-importance-{t}.csv`)."""
    dp = mesh if mesh is not None and mesh.n_data > 1 else None
    ranker = train_gbdt_ranker(feats, y, sess, FEATURE_NAMES, cfg.gbdt, valid=valid,
                               device=device, mesh_ctx=dp)
    if mesh is None or mesh.is_main:
        imp = ranker.feature_importance("gain")
        with open(os.path.join(work_dir, f"feat-importance-{tname}.csv"), "w") as fh:
            fh.write("feature,gain_importance\n")
            for i in np.argsort(-imp):
                fh.write(f"{FEATURE_NAMES[i]},{imp[i]:.6g}\n")
    log.info("ranker %s: %d rows, valid ndcg %s", tname, len(y), ranker.eval_history)
    return ranker


def _train_mlp(work_dir, tname, feats, y, sess, valid, cfg: Config, device, mesh):
    """train_ranker on float32 rows with cfg.ranker, alike on every rank."""
    ranker = train_ranker(feats.astype(np.float32, copy=False), y, sess, FEATURE_NAMES,
                          cfg.ranker, valid=valid, device=device)
    log.info("ranker %s (mlp): %d rows, %d steps, best epoch %d, valid ndcg %s",
             tname, len(y), ranker.steps, ranker.best_epoch, [h[2] for h in ranker.history])
    return ranker


@dataclasses.dataclass(frozen=True)
class RankerBackend:
    """One Config.ranker_backend: `file`, its saved rankers' name in the
    work dir (one a target type where it holds "{target}", else one for
    all three); `load(path, cfg)`; `train(work_dir, tname, feats, y,
    sessions, valid, cfg, device, mesh)` for one target, or None where
    the port serves the backend but does not train it."""

    file: str
    load: Callable[[str, Config], object]
    train: Optional[Callable] = None


# Config.ranker_backend's values. Adding one takes its model file, its
# row here and its config section: the CLI's --ranker-backend and
# refuse_training read their names from this table.
RANKER_BACKENDS: Dict[str, RankerBackend] = {
    "gbdt": RankerBackend("ranker-gbdt-{target}.npz",
                          lambda path, cfg: GBDTRanker.load(path), _train_gbdt),
    "mlp": RankerBackend("ranker-mlp-{target}.npz",
                         lambda path, cfg: Ranker.load(path, cfg.ranker), _train_mlp),
    "hstu": RankerBackend("ranker-hstu.npz", lambda path, cfg: HSTURanker.load(path)),
    "mla_moe": RankerBackend("ranker-mla_moe.npz", lambda path, cfg: MLAMoERanker.load(path)),
}


def backends_help() -> str:
    """The backends as the CLI lists them: which the port trains and which
    it only serves from a saved file."""
    trained = [n for n, b in RANKER_BACKENDS.items() if b.train is not None]
    served = [n for n, b in RANKER_BACKENDS.items() if b.train is None]
    return f"trained and served: {', '.join(trained)}; served from a saved file: " \
        f"{', '.join(served)}"


def _ranker_path(work_dir: str, tname: str, cfg: Config) -> str:
    name = RANKER_BACKENDS[cfg.ranker_backend].file.format(target=tname)
    return os.path.join(work_dir, name)


def refuse_training(cfg: Config) -> None:
    """The port trains the backends that have a trainer in RANKER_BACKENDS."""
    if RANKER_BACKENDS[cfg.ranker_backend].train is None:
        raise ValueError(
            f"ranker_backend {cfg.ranker_backend!r}: the port serves a saved ranker "
            f"({_ranker_path('<work_dir>', 'clicks', cfg)}) but does not train one; "
            f"run without labels ({backends_help()})")


def load_rankers(work_dir: str, cfg: Config = Config()) -> Dict[str, object]:
    """Read the rankers of cfg.ranker_backend that a training run of either
    package wrote into its work dir (RANKER_BACKENDS names their files:
    `ranker-{backend}-{clicks,carts,orders}.npz`, or one file that serves
    every target); each must be a ranker over retrieval's FEATURE_NAMES."""
    rankers, loaded = {}, {}
    for tname in TYPES:
        path = _ranker_path(work_dir, tname, cfg)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no trained {cfg.ranker_backend} ranker for '{tname}' at {path}; "
                "run the pipeline with labels first to train rankers"
            )
        if path not in loaded:
            loaded[path] = RANKER_BACKENDS[cfg.ranker_backend].load(path, cfg)
        rankers[tname] = loaded[path]
        check_serving_features(tname, rankers[tname])
    return rankers


# ---------------------------------------------------------------------------
# training: pass A, the rankers, the streaming runner
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PassAReport:
    """What `pass_a` measured: wall seconds (ended by a device sync), test
    sessions and batches, seconds per phase ("retrieve + device programs"
    on the producer's thread; "pulls + select + rows", the consumer's own
    time, on the worker thread when overlapped; "waiting for the
    consumer", the producer blocked on it; "eval + persist"), and per
    target the downsampled rows and the sessions with a positive."""

    seconds: float
    sessions: int
    batches: int
    phases: Dict[str, float]
    rows: Dict[str, int]
    positive_sessions: Dict[str, int]


def _rows_path(work_dir: str, tname: str) -> str:
    return os.path.join(work_dir, f"downsampled-{tname}.npz")


def pass_a(
    retriever: Retriever,
    test: Events,
    labels: Labels,
    ranker_cfg: RankerConfig,
    work_dir: str,
    batch_sessions: int = 512,
    skip_targets: Sequence[str] = (),
    overlap: bool = True,
    stage: StageFn = _no_stage,
) -> Tuple[Dict[str, float], PassAReport]:
    """Training pass A over the test sessions, batch by batch on the
    retriever's device: the packed meta and the label bits (the label join
    on 45-bit keys) and the per-source eval's counters, then on the host the
    downsample selection of every target (one default_rng(42) stream per
    type over the batches in order, drawn only for batches with a
    positive: each batch draws from it moved to where its draws begin,
    rank_engine.rng_at; with ranker_cfg.device_select the keep bits come
    from the device instead, batch g's from a generator seeded
    seed * 1_000_003 + g) and one float16 row gather of the selected rows,
    whose pull is finished one batch later.

    With `overlap` the host side runs on a worker thread while the next
    batch retrieves (pipelined_consume); the batches reach it in order,
    so rows, label bits, counters and the rng draws are those of the
    sequential loop.

    Writes into work_dir `eval_retrieved.json` (the ceiling recall),
    `eval_retrieved_sources.json` (the per-source report),
    `passA-metrics.json`, and for each target not in skip_targets its rows
    as `downsampled-{t}.npz` (feats f16, y int8, session; session-sorted).
    Each target's rows are sorted into one array while its batches' parts
    are freed, written, and freed before the next target's.

    `stage` (StageFn) hears otto_tpu's stages: "retrieve+downsample (pass
    A)", "eval_retrieved", "eval per-source" and "downsample {t}
    persisted" for each target written.

    With the retriever's mesh, each data rank runs its own batches (batch
    g on data rank g % n_data) and draws what one device draws for them.
    Where a batch's draws begin depends on every earlier batch's draw
    count (rank_engine.draw_count), so on more than one data rank the
    producer shares its batch's counts, taken on the device from the
    label bits, with one asynchronous all-gather a round of n_data batches
    (_draw_round), and the consumer waits for that round's counts: the
    producer never waits, and a consumer only on the other ranks'
    producers. Every collective of the loop is issued from the producer's
    thread, so the ranks issue them in one order. After its last batch a
    rank joins the rounds as "absent" until every rank is. The eval
    counters are all-reduced and the rows gathered to every rank; the
    files rank 0 writes are byte-equal to one device's.
    -> (metrics: ceiling_{type,total}, cand_per_session_{mean,min,max};
    PassAReport)."""
    dev = retriever.ctx.aid_emb.device
    mesh = getattr(retriever, "mesh", None)
    main = mesh is None or mesh.is_main
    rounds = mesh is not None and mesh.n_data > 1 and not ranker_cfg.device_select
    t0 = time.perf_counter()
    lab_keys = label_keys_device(labels, dev)
    drawn = np.zeros(3, np.int64)   # one device's draws a type before this round
    rows = {t: [] for t in TYPES}
    dev_eval = None
    n_sessions = n_batches = 0
    pend: list = []   # (rows handle, layout) of the batch whose pull is in flight

    def pack(b):
        """The batch's device programs (producer thread)."""
        nonlocal dev_eval, n_sessions, n_batches
        if ranker_cfg.device_select:
            gen = torch.Generator(device=dev).manual_seed(
                ranker_cfg.seed * 1_000_003 + b.index)
            meta, tbits_d = b.pack_meta_labels_select(
                lab_keys, gen, ranker_cfg.neg_to_pos_ratio,
                ranker_cfg.max_neg_per_session)
        else:
            meta, tbits_d = b.pack_meta_labels(lab_keys)
        if dev_eval is None:
            dev_eval = DeviceSourceEval(b.feats.shape[1], dev)
        dev_eval.update(meta, tbits_d)
        n_sessions += len(b.session)
        n_batches += 1
        shared = None
        if rounds:   # the label bits are 0 where a candidate is not valid
            shared = _draw_round(mesh, torch.stack([
                rank_engine.draw_count((tbits_d >> t) & 1 > 0) for t in range(3)]))
        return HostCopy(meta), HostCopy(tbits_d), shared

    def flush():
        handle, layout = pend.pop(0)
        feats = handle.numpy()
        off = 0
        for tname, cnt, y, sess in layout:
            # each target copies its rows out of the pinned buffer: one
            # target's parts share no memory with another's, so each is
            # freed when it is persisted
            rows[tname].append((feats[off: off + cnt].copy(), y, sess))
            off += cnt

    def consume(b, meta):
        """The batch's host side (worker thread when overlapped)."""
        meta_h, tbits_h, shared = meta
        b.unpack_meta(meta_h)
        tbits = tbits_h.numpy()
        sels = {}
        if ranker_cfg.device_select:
            for tname in TYPES:
                tid = TYPE2ID[tname]
                si, ci = np.nonzero((tbits >> (3 + tid)) & 1)
                if len(si):
                    sels[tname] = (si, ci, ((tbits[si, ci] >> tid) & 1).astype(np.float32))
        else:
            tgt = np.stack([(tbits >> ti) & 1 for ti in range(3)], axis=-1).astype(np.float32)
            # this round's draw counts in data-rank order (one batch alone
            # without rounds): the ranks before this one drew first
            rnd = np.stack([rank_engine.draw_counts([b], [tgt], tid) for tid in range(3)], -1)
            me = 0
            if shared is not None:
                mine, rnd, me = rnd[0], np.maximum(shared(), 0), mesh.data_rank
                if not np.array_equal(rnd[me], mine):
                    raise RuntimeError(f"pass A: batch {b.index}'s draw counts {mine} differ "
                                       f"from those it shared, {rnd[me]}")
            start = drawn + rnd[:me].sum(axis=0)
            drawn[:] += rnd.sum(axis=0)
            for tname in TYPES:
                tid = TYPE2ID[tname]
                got = rank_engine.downsample_select(b, tgt, tid, ranker_cfg,
                                                    rank_engine.rng_at(42, start[tid]))
                if got is not None:
                    sels[tname] = got
        if sels:
            handle, _ = b.feats_rows_async(
                np.concatenate([s[0] for s in sels.values()]),
                np.concatenate([s[1] for s in sels.values()]))
            pend.append((handle, [(t, len(si), y, b.session[si])
                                  for t, (si, _, y) in sels.items()]))
            while len(pend) > 1:
                flush()

    seconds = pipelined_consume(retriever.iter_run(test, batch_sessions=batch_sessions),
                                consume, pack=pack, overlap=overlap)
    while pend:
        flush()
    if rounds:
        # join the other ranks' remaining rounds until every rank is done
        absent = torch.full((3,), -1, dtype=torch.int64, device=dev)
        while (_draw_round(mesh, absent)() >= 0).any():
            pass
    if mesh is not None:
        counts = torch.tensor([n_sessions, n_batches, 0 if dev_eval is None else
                               dev_eval.n_cols], dtype=torch.int64, device=dev)
        mesh.all_sum(counts[:2])
        mesh.all_max(counts[2:])
        n_sessions, n_batches, n_cols = (int(x) for x in counts)
        if n_sessions:
            dev_eval = dev_eval or DeviceSourceEval(n_cols, dev)
            mesh.all_sum(dev_eval.hits)
            mesh.all_sum(dev_eval.hist)
    if not n_sessions:
        raise ValueError("pass A: no test sessions")
    t = time.perf_counter()
    phases = {"retrieve + device programs": seconds["produce"],
              "pulls + select + rows": seconds["consume"],
              "waiting for the consumer": seconds["wait"]}
    stage("retrieve+downsample (pass A)", f"{n_sessions} sessions; phases (s): "
          + json.dumps({k: round(v, 3) for k, v in phases.items()}), None)

    report = dev_eval.finalize(labels)
    ceiling = report.pop("_ceiling")
    if main:
        with open(os.path.join(work_dir, "eval_retrieved.json"), "w") as fh:
            json.dump(ceiling, fh, indent=2)
    stage("eval_retrieved", json.dumps(ceiling["total"]), None)
    if main:
        with open(os.path.join(work_dir, "eval_retrieved_sources.json"), "w") as fh:
            json.dump(report, fh, indent=2)
    log.info("per-source recall:\n%s", format_report(report))
    stage("eval per-source", "", None)
    metrics: Dict[str, float] = {
        f"ceiling_{k}": ceiling[k]["topall"] for k in ("clicks", "carts", "orders", "total")}
    anyc = report["_counts"]["src_any"]
    metrics["cand_per_session_mean"] = anyc["mean"]
    metrics["cand_per_session_min"] = anyc["min"]
    metrics["cand_per_session_max"] = anyc["max"]
    if main:
        with open(os.path.join(work_dir, "passA-metrics.json"), "w") as fh:
            json.dump(metrics, fh, indent=2)

    # every target's rows persisted before any training: a crash in
    # training resumes from them
    n_rows, n_pos_sessions = {}, {}
    for tname in TYPES:
        parts, rows[tname] = rows[tname], None
        if tname in skip_targets:
            continue
        if mesh is not None:   # every rank's parts, in data-rank order
            parts = [mesh.gather_arrays(
                _cat_rows([p[0] for p in parts], (0, len(FEATURE_NAMES)), np.float16),
                _cat_rows([p[1] for p in parts], (0,), np.float32),
                _cat_rows([p[2] for p in parts], (0,), np.int32).astype(np.int32))]
        feats, y, sess = _session_sorted_rows(parts)
        if not len(y):
            raise ValueError(f"no positive sessions for {tname}")
        if main:
            np.savez(_rows_path(work_dir, tname), feats=feats, y=y.astype(np.int8),
                     session=sess)
        n_rows[tname] = len(y)
        n_pos_sessions[tname] = int(np.unique(sess).size)
        del feats, y, sess
        stage(f"downsample {tname} persisted", f"{n_rows[tname]} rows", None)
    phases["eval + persist"] = time.perf_counter() - t
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rep = PassAReport(time.perf_counter() - t0, n_sessions, n_batches, phases,
                      n_rows, n_pos_sessions)
    log.info("pass A: %s", rep)
    return metrics, rep


def _session_sorted_rows(parts: list) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One target's pass-A parts [(feats f16 [n, F], y [n], sessions [n])]
    -> (feats, y float32, sessions int32) stably sorted by session, as
    concatenating them and indexing by a stable argsort gives; the rows
    are written into their sorted places part by part and each part is
    freed once placed (`parts` ends empty), so one copy of the rows is
    held, not three."""
    sess = _cat_rows([p[2] for p in parts], (0,), np.int32).astype(np.int32)
    y = _cat_rows([p[1] for p in parts], (0,), np.float32).astype(np.float32)
    order = np.argsort(sess, kind="stable")
    dest = np.empty(len(order), np.int64)
    dest[order] = np.arange(len(order))
    feats = np.empty((len(order), len(FEATURE_NAMES)), np.float16)
    off = 0
    while parts:
        f = parts.pop(0)[0]
        feats[dest[off: off + len(f)]] = f
        off += len(f)
    return feats, y[order], sess[order]


def _draw_round(mesh, draws: torch.Tensor) -> Callable[[], np.ndarray]:
    """One round of pass A's draw counts, started: every data rank's [3]
    int64 on its device (-1 for a rank without a batch this round) -> a
    function that waits for them and returns [n_data, 3] in data-rank
    order."""
    wait = mesh.gather_data(draws[None], async_op=True)
    return lambda: wait().cpu().numpy()


def train_ranker_cached(
    work_dir: str,
    tname: str,
    rows_fn: Callable[[], Tuple[np.ndarray, np.ndarray, np.ndarray]],
    cfg: Config,
    device,
    use_cache: bool = True,
    mesh=None,
    stage: StageFn = _no_stage,
):
    """One target's ranker of cfg.ranker_backend: its file in work_dir
    (RANKER_BACKENDS) when cached; else rows_fn() -> (feats, y, sessions),
    the sessions split 75/25 in ascending id order into train / valid (no
    valid set with fewer than 8 valid sessions), then the backend's
    trainer (_train_gbdt, _train_mlp) fits it on `device`, and it is saved
    to work_dir.

    With `mesh` (every rank calling with the same rows) every rank returns
    the same ranker and rank 0 writes the files. `stage` (StageFn) hears
    "ranker {t} ({backend})" when a ranker was trained (not when read)."""
    backend = RANKER_BACKENDS[cfg.ranker_backend]
    path = _ranker_path(work_dir, tname, cfg)
    main = mesh is None or mesh.is_main
    if mesh is not None:
        dist.barrier()   # every rank sees the cache as it stands now
    cached = use_cache and os.path.exists(path)
    if mesh is not None:
        dist.barrier()
    if cached:
        return backend.load(path, cfg)
    refuse_training(cfg)
    feats, y, sess = rows_fn()
    u_sess = np.unique(sess)
    n_train = max(1, int(len(u_sess) * 0.75))
    valid = None
    if len(u_sess) - n_train >= 8:
        vmask = np.isin(sess, u_sess[n_train:])
        valid = (feats[vmask], y[vmask], sess[vmask])
        feats, y, sess = feats[~vmask], y[~vmask], sess[~vmask]
    ranker = backend.train(work_dir, tname, feats, y, sess, valid, cfg, device, mesh)
    if main:
        ranker.save(path)
    stage(f"ranker {tname} ({cfg.ranker_backend})", f"{len(y)} rows", None)
    return ranker


def load_downsampled(work_dir: str, tname: str):
    """A target's persisted pass-A rows -> (feats f16, y int8, sessions)."""
    z = np.load(_rows_path(work_dir, tname))
    return z["feats"], z["y"], z["session"]


def check_work_dir(work_dir: str, cfg: Config, n_aids: int, use_cache: bool) -> None:
    """otto_tpu's guard against a stale work dir: with use_cache and a
    `config.json` / `meta.json` already there, raise ValueError unless the
    stored config holds cfg (every section but work_dir; stored fields the
    port lacks, such as otto_tpu's TPU-only ones, are not compared) and
    the stored n_aids is n_aids; otherwise write both files."""
    os.makedirs(work_dir, exist_ok=True)
    cpath = os.path.join(work_dir, "config.json")
    if use_cache and os.path.exists(cpath):
        with open(cpath) as fh:
            stale = stale_sections(cfg, json.load(fh))
        if stale:
            raise ValueError(
                f"work dir {work_dir!r} holds artifacts for a DIFFERENT config "
                f"(mismatched sections: {stale}); use a fresh work dir or "
                "use_cache=False")
    else:
        config_to_json(cfg, cpath)
    mpath = os.path.join(work_dir, "meta.json")
    if use_cache and os.path.exists(mpath):
        with open(mpath) as fh:
            stored = json.load(fh).get("n_aids")
        if stored != n_aids:
            raise ValueError(
                f"work dir {work_dir!r} holds artifacts for n_aids={stored} "
                f"(got {n_aids}); use a fresh work dir or use_cache=False")
    else:
        with open(mpath, "w") as fh:
            json.dump({"n_aids": n_aids}, fh)


def check_mesh_device(device, mesh) -> None:
    """A stage given a mesh runs on the mesh's device: a `device` of
    another type, or another card, is the caller's error (never a quiet
    switch to the mesh's)."""
    if mesh is None:
        return
    dev, md = torch.device(device), mesh.device
    if dev.type != md.type or (dev.index is not None and md.index is not None
                               and dev.index != md.index):
        raise ValueError(f"device {dev} is not the mesh's device {md}; pass "
                         f"device={str(md)!r}, or build the mesh on {dev}")


def guard_work_dir(work_dir: str, cfg: Config, n_aids: int, use_cache: bool,
                   mesh=None) -> None:
    """check_work_dir, on rank 0 alone when there is a mesh (the other
    ranks wait for it)."""
    if mesh is None or mesh.is_main:
        check_work_dir(work_dir, cfg, n_aids, use_cache)
    if mesh is not None:
        dist.barrier()


def run_streaming(
    train: Events,
    test: Events,
    labels: Optional[Labels],
    n_aids: int,
    work_dir: str,
    device,
    cfg: Config = Config(),
    batch_sessions: int = 512,
    use_cache: bool = True,
    mesh=None,
    stage: StageFn = _no_stage,
) -> Dict[str, float]:
    """The pipeline from events to recall@20 on `device`, as otto_tpu's
    Pipeline.run_streaming: check_work_dir, build_retriever with work_dir
    as its artifact cache, then with labels pass_a, the three rankers
    (train_ranker_cached) and pass B (score_pass) -> submit_and_eval;
    without labels, the rankers in work_dir score pass B.

    Crash-resume: with use_cache, when `passA-metrics.json` and, for every
    target, its ranker or its persisted rows are in work_dir, pass A is
    skipped and the missing rankers train from the rows.

    With `mesh`, every stage runs its mesh branch on `device` (this rank's),
    and every rank returns the same metrics.

    `stage` (StageFn) hears otto_tpu's stages as each ends, in its order:
    build_retriever's, then pass_a's, "ranker {t} ({backend})" for each
    ranker trained, "score (pass B)", "submit", "eval"; a resumed run
    hears "pass A + rankers (cached)" in place of pass A's, and a run
    without labels "score (inference-only)" and "submit".
    -> metrics: pass A's and recall@20 per type and total ({} without
    labels)."""
    check_mesh_device(device, mesh)
    if labels is not None:
        refuse_training(cfg)
    guard_work_dir(work_dir, cfg, n_aids, use_cache, mesh)
    retriever, _ = build_retriever(
        train, test, n_aids, device, cfg.w2vec, None, cfg.covis, cfg.popularity,
        cfg.retrieval, cfg.kmeans, report_dir=work_dir, cache_dir=work_dir,
        use_cache=use_cache, mesh=mesh, stage=stage)
    if labels is None:
        preds = score_pass(retriever, test, load_rankers(work_dir, cfg), batch_sessions)
        stage("score (inference-only)", "", None)
        _submit_on_main(work_dir, preds, None, mesh, stage)
        return {}

    pm_path = os.path.join(work_dir, "passA-metrics.json")
    have_ranker = {t: use_cache and os.path.exists(_ranker_path(work_dir, t, cfg))
                   for t in TYPES}
    resumed = use_cache and os.path.exists(pm_path) and all(
        have_ranker[t] or os.path.exists(_rows_path(work_dir, t)) for t in TYPES)
    if resumed:
        with open(pm_path) as fh:
            metrics = json.load(fh)
        log.info("pass A cached in %s", work_dir)
    else:
        metrics, _ = pass_a(retriever, test, labels, cfg.ranker, work_dir, batch_sessions,
                            skip_targets=[t for t in TYPES if have_ranker[t]], stage=stage)
    rankers = {
        t: train_ranker_cached(work_dir, t, lambda t=t: load_downsampled(work_dir, t),
                               cfg, device, use_cache, mesh, stage)
        for t in TYPES
    }
    if resumed:
        stage("pass A + rankers (cached)", "", None)
    preds = score_pass(retriever, test, rankers, batch_sessions)
    stage("score (pass B)", "", None)
    metrics.update(_submit_on_main(work_dir, preds, labels, mesh, stage))
    return metrics


# ---------------------------------------------------------------------------
# the Pipeline over a work dir, and its batch runner
# ---------------------------------------------------------------------------
def host_rss_gb() -> float:
    """Resident host memory of this process, in GiB (0 where /proc is
    missing)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 2**20
    except OSError:
        pass
    return 0.0


@dataclasses.dataclass
class Pipeline:
    """otto_tpu's Pipeline: `cfg`, the artifact `work_dir`,
    `n_aids`, `use_cache` (False: rebuild and overwrite every artifact)
    and `device` (default "cuda", which raises without a card; tests pass
    "cpu"). Construction resolves the device and runs the work-dir guard
    (check_work_dir).

    `run_streaming` is the module's run_streaming; `run` is the batch
    runner, which keeps every retrieval batch on the device and evaluates
    C14 on the host. Both give the same metrics from the same work dir.
    `stage_log` collects one entry a stage as it ends, with otto_tpu's
    stage names and in its order: `stage`, `elapsed_s` (seconds since the
    calling method began), `rss_gb` (host RSS), `msg` where there is one
    and, on CUDA, `peak_mem_gb`, the peak device memory allocated within
    the stage (the allocator's peak is reset as each entry is taken).

    `mesh` (a parallel.mesh.MeshContext; not part of the cache key) runs
    every stage's mesh branch on this rank's device (mesh.device, which
    `device` must name: ValueError otherwise), in either runner; both
    write one device's files and return one device's metrics on every
    rank."""

    cfg: Config
    work_dir: str
    n_aids: int
    use_cache: bool = True
    device: object = "cuda"
    mesh: Optional[object] = None

    def __post_init__(self):
        check_mesh_device(self.device, self.mesh)
        self.device = resolve(self.device if self.mesh is None else self.mesh.device)
        guard_work_dir(self.work_dir, self.cfg, self.n_aids, self.use_cache, self.mesh)
        self.stage_log: List[Dict] = []
        self.build_report: Optional[BuildReport] = None

    def _p(self, name: str) -> str:
        return os.path.join(self.work_dir, name)

    def _cached(self, name: str) -> bool:
        return self.use_cache and os.path.exists(self._p(name))

    def _log(self, stage: str, t0: float, msg: str = "",
             peak_bytes: Optional[int] = None) -> None:
        el = time.time() - t0
        entry = {"stage": stage, "elapsed_s": round(el, 3), "rss_gb": round(host_rss_gb(), 2)}
        if self.device.type == "cuda":
            peak = max(peak_bytes or 0, torch.cuda.max_memory_allocated(self.device))
            torch.cuda.reset_peak_memory_stats(self.device)
            entry["peak_mem_gb"] = round(peak / 2**30, 2)
        if msg:
            entry["msg"] = msg
        self.stage_log.append(entry)
        log.info("[%7.1fs] %s %s", el, stage, msg)

    def _stage(self, t0: float) -> StageFn:
        """A StageFn that logs each stage into stage_log, timed from t0."""
        return lambda name, msg="", peak_bytes=None: self._log(name, t0, msg, peak_bytes)

    # ------------------------------------------------------------------
    def run(self, train: Events, test: Events, labels: Optional[Labels] = None,
            batch_sessions: int = 256) -> Dict[str, float]:
        """The batch runner: retrieve_with_features, then with labels
        rank_and_eval; without labels the work dir's rankers score every
        batch and the submission is written (metrics stay empty). With a
        mesh, each data rank keeps the batches dealt to it; the files
        rank 0 writes are those of one device."""
        if labels is not None:
            refuse_training(self.cfg)
        batches, targets, metrics = self.retrieve_with_features(
            train, test, labels, batch_sessions=batch_sessions)
        if labels is not None:
            self.rank_and_eval(batches, targets, labels, metrics)
        else:
            t0 = time.time()
            preds = self._score(batches, self.load_rankers())
            self._log("score (inference-only)", t0)
            self._submit_and_eval(preds, None, metrics, t0)
        return metrics

    def run_streaming(self, train: Events, test: Events, labels: Optional[Labels] = None,
                      batch_sessions: int = 512) -> Dict[str, float]:
        """The two-pass streaming runner (module run_streaming): one batch's
        features on the device at a time."""
        return run_streaming(train, test, labels, self.n_aids, self.work_dir,
                             self.device, self.cfg, batch_sessions, self.use_cache,
                             self.mesh, stage=self._stage(time.time()))

    def build_retriever(self, train: Events, test: Events) -> Retriever:
        """C7-C12 with the work dir as the artifact cache (module
        build_retriever); its BuildReport is kept as `build_report`."""
        cfg = self.cfg
        retriever, self.build_report = build_retriever(
            train, test, self.n_aids, self.device, cfg.w2vec, None, cfg.covis,
            cfg.popularity, cfg.retrieval, cfg.kmeans, report_dir=self.work_dir,
            cache_dir=self.work_dir, use_cache=self.use_cache, mesh=self.mesh,
            stage=self._stage(time.time()))
        return retriever

    def retrieve_with_features(self, train: Events, test: Events,
                               labels: Optional[Labels] = None, batch_sessions: int = 256):
        """C7-C14: build_retriever, every test batch retrieved at once
        (Retriever.run; with a mesh, this data rank's batches), then with
        labels join_labels and the C14 eval (_eval_retrieved; with a mesh
        over every rank's batches in one device's order).
        -> (batches, targets or None, metrics)."""
        t0 = time.time()
        retriever = self.build_retriever(train, test)
        batches = retriever.run(test, batch_sessions=batch_sessions)
        self._sync()
        self._log("retrieve", t0, f"{sum(len(b.session) for b in batches)} sessions")
        targets = None
        metrics: Dict[str, float] = {}
        if labels is not None:
            targets = join_labels(batches, labels)
            if self.mesh is None:
                metrics = self._eval_retrieved(
                    np.concatenate([b.session for b in batches]),
                    np.concatenate([b.cand for b in batches]), batches, labels, t0)
            else:
                metrics = self._eval_retrieved_mesh(batches, labels, t0)
        return batches, targets, metrics

    def _eval_retrieved(self, all_sess, all_cand, src_batches, labels, t0) -> Dict[str, float]:
        """C14 on the host: the retrieval ceiling (recall_at_k of every
        candidate) into `eval_retrieved.json` and the per-source report
        (eval_retrieved_by_source; the flags packed on the device) into
        `eval_retrieved_sources.json`. src_batches: RetrievedBatch or
        SrcFlagBatch."""
        metrics: Dict[str, float] = {}
        ceiling = recall_at_k(all_sess, all_cand, labels, cutoffs=(20, 100, 200))
        with open(self._p("eval_retrieved.json"), "w") as fh:
            json.dump(ceiling, fh, indent=2)
        for t in ("clicks", "carts", "orders", "total"):
            metrics[f"ceiling_{t}"] = ceiling[t]["topall"]
        self._log("eval_retrieved", t0, json.dumps(ceiling["total"]))
        per_src = eval_retrieved_by_source(src_batches, labels)
        with open(self._p("eval_retrieved_sources.json"), "w") as fh:
            json.dump(per_src, fh, indent=2)
        log.info("per-source recall:\n%s", format_report(per_src))
        self._log("eval per-source", t0)
        return metrics

    def _eval_retrieved_mesh(self, batches, labels, t0) -> Dict[str, float]:
        """_eval_retrieved over every data rank's batches: each rank's
        sessions, candidates and packed source flags are gathered to data
        rank 0, put back in one device's batch order (their global batch
        index, stably) and evaluated on rank 0, whose metrics every rank
        returns."""
        mesh = self.mesh
        src = [SrcFlagBatch.from_batch(b) for b in batches]
        n_cand = self.cfg.retrieval.max_candidates
        got = mesh.gather_arrays_to_first(
            _cat_rows([np.full(len(b.session), b.index, np.int32) for b in batches], (0,),
                      np.int32),
            _cat_rows([b.session for b in src], (0,), np.int32),
            _cat_rows([b.cand for b in src], (0, n_cand), np.int32),
            _cat_rows([b.flags for b in src], (0, n_cand), np.uint16).view(np.int16))
        del src
        metrics = [None]
        if mesh.is_main:
            index, sess, cand, flags = got
            order = np.argsort(index, kind="stable")
            sess, cand = sess[order], cand[order]
            metrics[0] = self._eval_retrieved(
                sess, cand, [SrcFlagBatch(sess, cand, flags[order].view(np.uint16))],
                labels, t0)
        dist.broadcast_object_list(metrics, src=0)
        if not mesh.is_main:
            self._log("eval per-source", t0, "on rank 0")
        return metrics[0]

    def rank_and_eval(self, batches, targets, labels: Labels,
                      metrics: Optional[Dict[str, float]] = None) -> Dict[str, float]:
        """C15-C19 on the kept batches: each target's ranker (cached, or
        trained from _downsample's rows), the top-20 of every batch per
        target, then the submission and recall@20. With a mesh, every rank
        trains from one device's rows (a GBDT data-parallel) and scores its
        own batches. Mutates and returns `metrics`."""
        t0 = time.time()
        metrics = {} if metrics is None else metrics
        rankers = {
            t: self._train_ranker_cached(
                t, lambda t=t: self._downsample(batches, targets, TYPE2ID[t]), t0)
            for t in TYPES
        }
        preds = self._score(batches, rankers)
        self._sync()
        self._log("score", t0)
        return self._submit_and_eval(preds, labels, metrics, t0)

    def _downsample(self, batches, targets, tid: int):
        """One target's rows of rank_engine.downsample: each batch draws
        from where its draws begin in one device's rng stream. With a mesh,
        each rank downsamples its own batches (every rank's draw counts
        gathered, in one device's batch order) and the rows are gathered
        to every rank: one device's rows."""
        index = np.array([b.index for b in batches], np.int64)
        counts = rank_engine.draw_counts(batches, targets, tid)
        if self.mesh is not None:
            index, counts = self.mesh.gather_arrays(index, counts)
        order = np.argsort(index)
        begin = dict(zip(index[order].tolist(),
                         rank_engine.draw_starts(counts[order]).tolist()))
        rows = rank_engine.downsample_parts(batches, targets, tid, self.cfg.ranker,
                                            [begin[b.index] for b in batches])
        if self.mesh is not None:
            rows = self.mesh.gather_arrays(*rows)
        return rank_engine.session_sorted(*rows, tid)

    def _score(self, batches, rankers) -> Dict[str, tuple]:
        """score_pass's scoring and assembly of the kept batches; with a
        mesh, every rank's."""
        ranker_list = [rankers[t] for t in TYPES]
        return assemble_preds(
            [(b.session, rank_engine.score_topk_multi(b, ranker_list)) for b in batches],
            self.mesh)

    def _train_ranker_cached(self, tname: str, rows_fn, t0: float):
        return train_ranker_cached(self.work_dir, tname, rows_fn, self.cfg, self.device,
                                   self.use_cache, self.mesh, self._stage(t0))

    def _submit_and_eval(self, preds, labels, metrics, t0):
        """submit_and_eval into the work dir (rank 0 with a mesh); with
        labels its recall@20 joins `metrics`. -> metrics."""
        res = _submit_on_main(self.work_dir, preds, labels, self.mesh, self._stage(t0))
        if res is not None:
            metrics.update(res)
        return metrics

    def load_rankers(self) -> Dict[str, object]:
        return load_rankers(self.work_dir, self.cfg)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def run_synthetic(
    cfg: Config,
    work_dir: str,
    spec: SyntheticSpec,
    batch_sessions: int = 256,
    streaming: Optional[bool] = None,
    device="cuda",
    mesh=None,
) -> Dict[str, float]:
    """otto_tpu's generated events (data.synthetic.generate), split as
    cfg.data says, through a Pipeline on `device` (with `mesh`, on every
    rank): the streaming runner past 50k test sessions (or as `streaming`
    says), else the batch runner. -> its metrics."""
    pipe = Pipeline(cfg=cfg, work_dir=work_dir, n_aids=spec.n_aids, device=device,
                    mesh=mesh)
    sp = split_events(generate(spec), cfg.data.test_days, cfg.data.seed)
    if streaming is None:
        streaming = len(np.unique(sp.test.session)) > 50_000
    runner = pipe.run_streaming if streaming else pipe.run
    return runner(sp.train, sp.test, sp.labels, batch_sessions=batch_sessions)
