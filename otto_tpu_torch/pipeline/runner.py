"""The ported functions of the pipeline.

Counterpart of otto_tpu/pipeline/runner.py's embedding-table build and
its serving pass and tail:

- `build_retriever`: the item kNN tables (C9), the session embeddings
  (C10) and the session clusters (C11) on the device, and the Retriever
  that serves from them;
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
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from otto_tpu_torch.config import TYPES, KMeansConfig, RetrievalConfig
from otto_tpu_torch.data.batching import pack_sessions
from otto_tpu_torch.data.schema import Events, Labels
from otto_tpu_torch.engine import rank as rank_engine
from otto_tpu_torch.engine.covis import CoVisTables
from otto_tpu_torch.engine.popularity import PopularityTables
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
from otto_tpu_torch.ops.kmeans import kmeans_fit

log = logging.getLogger(__name__)


@dataclasses.dataclass
class BuildReport:
    """What `build_retriever` measured: seconds per stage (ended by a device
    sync), the w2vec x co-visitation overlap per model, and the k-means
    fit (inertia, n_iter, n_points, n_nonempty clusters)."""

    seconds: Dict[str, float]
    overlap: Dict[str, Dict[str, float]]
    kmeans: Dict[str, float]


def build_retriever(
    train: Events,
    test: Events,
    covis: Sequence[CoVisTables],
    models: Dict[str, Word2Vec],
    pop_cl50: PopularityTables,
    pop_cl1: PopularityTables,
    n_aids: int,
    device,
    retrieval: RetrievalConfig = RetrievalConfig(),
    kmeans: KMeansConfig = KMeansConfig(),
    report_dir: Optional[str] = None,
) -> Tuple[Retriever, BuildReport]:
    """Stages C9-C11 and the retrieval context, on `device`.

    Takes what the port does not build yet: the five co-visitation tables
    (in COVIS_FIRST_N order), the two word2vec models by name (in
    W2VEC_MODELS order; the first is the main model, whose table becomes
    the item embeddings) and the two popularity tables, all on `device`.
    Runs, as otto_tpu's Pipeline.build_retriever does:
      C9  `build_knn_tables` for each model (K3), then the w2vec x
          click-to-click co-visitation overlap (logged; written as
          `stats_w2vec_x_co_click-{name}.csv` into `report_dir` if given);
      C10 `compute_session_embeddings` over every session of train + test
          with the main model's table (K4);
      C11 `kmeans_fit` with `n_clusters_to_find[0]` clusters.
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

    # ---- C9 kNN -----------------------------------------------------------
    knns = {}
    for name, model in models.items():
        knns[name] = build_knn_tables(model, n_aids, dev)
        lap(f"knn {name}")
    co_nbr = covis[0].neighbor.cpu().numpy()
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
    main_model = next(iter(models.values()))
    aid_emb = torch.from_numpy(main_model.embedding_by_aid(n_aids)).to(dev)
    sess_ids, sess_emb = compute_session_embeddings(
        pack_sessions(train.concat(test)), aid_emb)
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

    names = list(models)
    ctx = RetrievalContext(
        covis=tuple(covis),
        knn_all=tuple(knns[names[0]]),
        knn_1_2=tuple(knns[names[1]]),
        pop_cl50_cand=pop_cl50.candidate,
        pop_cl50_ranks=pop_cl50.ranks,
        pop_cl1_rank=pop_cl1.aid_rank,
        aid_emb=aid_emb,
    )
    retriever = Retriever(
        ctx=ctx, cfg=retrieval,
        sessions=SessionLookup.build(sess_ids, labels, sess_emb.cpu().numpy()),
    )
    lap("context")
    return retriever, BuildReport(seconds, overlap, km)


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
