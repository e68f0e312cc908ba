"""The ported functions of the pipeline.

Counterpart of otto_tpu/pipeline/runner.py's table build and its serving
pass and tail:

- `build_retriever`: co-visitation counting (C7), the item kNN tables
  (C9), the session embeddings (C10), the session clusters (C11) and
  cluster popularity (C12) on the device, and the Retriever that serves
  from them;
- `score_pass`: re-retrieve the test sessions, score every batch with the
  three target rankers on the device, keep the top-20 per target;
- `submit_and_eval`: write the submission file and evaluate recall@20.

Plain loops: the batches run one after the other on the device's stream.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from otto_tpu_torch.config import (
    TYPES,
    CoVisConfig,
    KMeansConfig,
    PopularityConfig,
    RetrievalConfig,
)
from otto_tpu_torch.data.batching import pack_sessions
from otto_tpu_torch.data.schema import Events, Labels
from otto_tpu_torch.engine import rank as rank_engine
from otto_tpu_torch.engine.covis import CoVisCounter
from otto_tpu_torch.engine.popularity import compute_popularity
from otto_tpu_torch.engine.retrieval import (
    RetrievalContext,
    Retriever,
    SessionLookup,
)
from otto_tpu_torch.engine.session_embed import (
    build_knn_tables,
    compute_session_embeddings,
)
from otto_tpu_torch.eval.diagnostics import w2vec_covis_overlap, write_overlap_report
from otto_tpu_torch.eval.recall import evaluate_topk
from otto_tpu_torch.models.gbdt import GBDTRanker
from otto_tpu_torch.models.word2vec import Word2Vec
from otto_tpu_torch.ops import counts as counts_ops
from otto_tpu_torch.ops.kmeans import kmeans_fit

log = logging.getLogger(__name__)


@dataclasses.dataclass
class BuildReport:
    """What `build_retriever` measured: seconds per stage (ended by a device
    sync; "covis count" is both updates, "covis tables" the global merge,
    prune and top-N tables), the co-visitation counter's work (`covis`:
    seconds of host dedup and packing, microbatches, grid lanes, emitted
    pairs, ladder merges, rows spilled and pruned, the host
    merge that ran, unique pairs per type before / after the global prune,
    rows with a neighbour per table), the w2vec x co-visitation overlap
    per model, the k-means fit (inertia, n_iter, n_points, n_nonempty
    clusters) and the popularity tables' fill (`popularity`: candidates
    per cluster, aids ranked)."""

    seconds: Dict[str, float]
    covis: Dict[str, object]
    overlap: Dict[str, Dict[str, float]]
    kmeans: Dict[str, float]
    popularity: Dict[str, object]


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
    models: Dict[str, Word2Vec],
    n_aids: int,
    device,
    covis: CoVisConfig = CoVisConfig(),
    popularity: PopularityConfig = PopularityConfig(),
    retrieval: RetrievalConfig = RetrievalConfig(),
    kmeans: KMeansConfig = KMeansConfig(),
    report_dir: Optional[str] = None,
) -> Tuple[Retriever, BuildReport]:
    """Stages C7 and C9-C12 and the retrieval context, on `device`.

    Takes what the port does not build yet: the two word2vec models by
    name (in W2VEC_MODELS order; the first is the main model, whose table
    becomes the item embeddings). Runs, as otto_tpu's
    Pipeline.build_retriever does:
      C7  a CoVisCounter over train, then over test, and its retrieval
          tables (five, in `covis.names` order);
      C9  `build_knn_tables` for each model (K3), then the w2vec x
          click-to-click co-visitation overlap (logged; written as
          `stats_w2vec_x_co_click-{name}.csv` into `report_dir` if given);
      C10 `compute_session_embeddings` over every session of train + test
          with the main model's table (K4);
      C11 `kmeans_fit` with `n_clusters_to_find[0]` clusters;
      C12 `compute_popularity` of train + test over those clusters and
          over one cluster.
    Writes no artifact cache. -> (Retriever, BuildReport)."""
    dev = torch.device(device)
    if len(models) != 2:
        raise ValueError(f"build_retriever: two w2vec models, got {list(models)}")
    seconds: Dict[str, float] = {}
    t = time.perf_counter()

    def lap(stage):
        nonlocal t
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        seconds[stage] = now - t
        t = now

    # ---- C7 co-visitation --------------------------------------------------
    counter = CoVisCounter(covis, dev)
    try:
        counter.update(train)
        counter.update(test)
        lap("covis count")
        tables = counter.retrieval_tables(n_aids)
    finally:
        counter.close()
    covis_tables = tuple(tables[name] for name in covis.names)
    covis_rep = _covis_report(counter, tables)
    log.info("covis %s", covis_rep)
    lap("covis tables")

    # ---- C9 kNN -----------------------------------------------------------
    knns = {}
    for name, model in models.items():
        knns[name] = build_knn_tables(model, n_aids, dev)
        lap(f"knn {name}")
    co_nbr = covis_tables[0].neighbor.cpu().numpy()
    overlap = {}
    for name, kt in knns.items():
        overlap[name] = w2vec_covis_overlap(kt.neighbor.cpu().numpy(), co_nbr)
        log.info("w2vec overlap %s: %s", name, overlap[name])
        if report_dir is not None:
            write_overlap_report(
                os.path.join(report_dir, f"stats_w2vec_x_co_click-{name}.csv"),
                overlap[name])
    lap("overlap")

    # ---- C10 session embeddings --------------------------------------------
    full = train.concat(test)
    main_model = next(iter(models.values()))
    aid_emb = torch.from_numpy(main_model.embedding_by_aid(n_aids)).to(dev)
    sess_ids, sess_emb = compute_session_embeddings(pack_sessions(full), aid_emb)
    lap("session_emb")

    # ---- C11 kmeans --------------------------------------------------------
    n_clusters = kmeans.n_clusters_to_find[0]
    _, labels, inertia, n_iter = kmeans_fit(
        sess_emb, n_clusters, max_iter=kmeans.max_iter, tol=kmeans.tol,
        seed=kmeans.seed)
    labels = labels.cpu().numpy()
    km = {"inertia": inertia, "n_iter": n_iter, "n_points": len(labels),
          "n_nonempty": int(np.unique(labels).size)}
    log.info("kmeans %s", km)
    lap("kmeans")

    # ---- C12 popularity ----------------------------------------------------
    pop50 = compute_popularity(
        full, _event_clusters(full.session, sess_ids, labels), n_clusters,
        n_aids, popularity, dev)
    pop1 = compute_popularity(
        full, np.zeros(len(full), np.int32), 1, n_aids, popularity, dev)
    pop_rep = {"cl50": _popularity_report(pop50), "cl1": _popularity_report(pop1)}
    log.info("popularity %s", pop_rep)
    lap("popularity")

    names = list(models)
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
    )
    lap("context")
    return retriever, BuildReport(seconds, covis_rep, overlap, km, pop_rep)


def score_pass(
    retriever: Retriever, test: Events, rankers: Dict[str, object],
    batch_sessions: int,
) -> Dict[str, tuple]:
    """One scoring pass: retrieve, score all three targets per batch on the
    device, pull one stacked [3, S, 20] aid array per batch.
    -> {type name: (sessions [N] sorted, top-20 aids [N, 20])}."""
    pieces = {t: ([], []) for t in TYPES}
    ranker_list = [rankers[t] for t in TYPES]
    for b in retriever.iter_run(test, batch_sessions=batch_sessions):
        multi = rank_engine.score_topk_multi(b, ranker_list)
        for i, tname in enumerate(TYPES):
            pieces[tname][0].append(b.session)
            pieces[tname][1].append(multi[i])
    preds = {}
    for tname in TYPES:
        s = np.concatenate(pieces[tname][0])
        a = np.concatenate(pieces[tname][1])
        order = np.argsort(s, kind="stable")
        preds[tname] = (s[order], a[order])
    return preds


def submit_and_eval(
    work_dir: str, preds: Dict[str, tuple], labels: Optional[Labels]
) -> Optional[Dict[str, float]]:
    """Write `submission.csv` into work_dir; with labels, evaluate recall@20
    (written to `eval_submission.json`) and cross-check it against an
    independent re-parse of the CSV. -> the recall dict, or None without
    labels."""
    path = os.path.join(work_dir, "submission.csv")
    rank_engine.write_submission(path, preds)
    if labels is None:
        return None
    res = evaluate_topk(preds, labels)
    with open(os.path.join(work_dir, "eval_submission.json"), "w") as fh:
        json.dump(res, fh, indent=2)

    sub = rank_engine.read_submission(path)
    reparsed = {}
    for tname in TYPES:
        rows = sub.get(tname, {})
        sessions = np.fromiter(rows.keys(), np.int32, len(rows))
        aids = np.full((len(rows), 20), -1, np.int32)
        for i, alist in enumerate(rows.values()):
            aids[i, : min(len(alist), 20)] = alist[:20]
        reparsed[tname] = (sessions, aids)
    res2 = evaluate_topk(reparsed, labels)
    if abs(res2["total"] - res["total"]) > 1e-9:
        raise RuntimeError(
            f"submission re-parse mismatch: {res2['total']} vs {res['total']}"
        )
    return res


def load_rankers(work_dir: str) -> Dict[str, GBDTRanker]:
    """Read the three `ranker-gbdt-{clicks,carts,orders}.npz` files that the
    otto_tpu pipeline writes into its work dir."""
    rankers = {}
    for tname in TYPES:
        path = os.path.join(work_dir, f"ranker-gbdt-{tname}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no trained gbdt ranker for '{tname}' at {path}; "
                "train the rankers with the otto_tpu pipeline first"
            )
        rankers[tname] = GBDTRanker.load(path)
    return rankers
