"""The ported functions of the pipeline.

Counterpart of otto_tpu/pipeline/runner.py's streaming runner
(`Pipeline.run_streaming`) and the stages it runs:

- `build_retriever`: co-visitation counting (C7), word2vec training
  (C8), the item kNN tables (C9), the session embeddings (C10), the
  session clusters (C11) and cluster popularity (C12) on the device, and
  the Retriever that serves from them;
- `pass_a`: retrieve the test sessions with labels: the label join, the
  per-source retrieval eval (C14) and negative downsampling (C15), whose
  rows are persisted per target before any training;
- `train_ranker_cached`: one target's GBDT ranker (C16) from those rows;
- `score_pass`: re-retrieve the test sessions, score every batch with the
  three target rankers on the device, keep the top-20 per target;
- `submit_and_eval`: write the submission file and evaluate recall@20;
- `run_streaming`: all of them in that order, with otto_tpu's work-dir
  guard (`check_work_dir`) and crash-resume fast path.

Plain loops: the batches run one after the other on the device's stream.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from otto_tpu_torch.config import (
    TYPE2ID,
    TYPES,
    W2VEC_MODELS,
    Config,
    CoVisConfig,
    GBDTConfig,
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
from otto_tpu_torch.engine import rank as rank_engine
from otto_tpu_torch.engine.covis import CoVisCounter
from otto_tpu_torch.engine.popularity import compute_popularity
from otto_tpu_torch.engine.retrieval import (
    FEATURE_NAMES,
    RetrievalContext,
    Retriever,
    SessionLookup,
    label_keys_device,
)
from otto_tpu_torch.engine.session_embed import (
    build_knn_tables,
    compute_session_embeddings,
)
from otto_tpu_torch.eval.diagnostics import w2vec_covis_overlap, write_overlap_report
from otto_tpu_torch.eval.per_source import DeviceSourceEval, format_report
from otto_tpu_torch.eval.recall import evaluate_topk
from otto_tpu_torch.models.gbdt import GBDTRanker, train_gbdt_ranker
from otto_tpu_torch.models.word2vec import Word2Vec, train_word2vec, train_word2vec_device
from otto_tpu_torch.ops import counts as counts_ops
from otto_tpu_torch.ops.kmeans import kmeans_fit

log = logging.getLogger(__name__)


@dataclasses.dataclass
class BuildReport:
    """What `build_retriever` measured: seconds per stage (ended by a device
    sync; "covis count" is both updates, "covis tables" the global merge,
    prune and top-N tables, "w2vec {name}" a model's training), on CUDA
    the peak bytes allocated within each stage, the co-visitation
    counter's work (`covis`: seconds of host dedup and packing,
    microbatches, grid lanes, emitted pairs, ladder merges, rows spilled
    and pruned, the host merge that ran, unique pairs per type before /
    after the global prune, rows with a neighbour per table), what each
    trained word2vec model ran (`w2vec`), the w2vec x co-visitation
    overlap per model, the k-means fit (inertia, n_iter, n_points,
    n_nonempty clusters) and the popularity tables' fill (`popularity`:
    candidates per cluster, aids ranked)."""

    seconds: Dict[str, float]
    peak_bytes: Dict[str, int]
    covis: Dict[str, object]
    w2vec: Dict[str, object]
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
    n_aids: int,
    device,
    w2vec: Dict[str, Word2VecConfig] = W2VEC_MODELS,
    models: Optional[Dict[str, Word2Vec]] = None,
    covis: CoVisConfig = CoVisConfig(),
    popularity: PopularityConfig = PopularityConfig(),
    retrieval: RetrievalConfig = RetrievalConfig(),
    kmeans: KMeansConfig = KMeansConfig(),
    report_dir: Optional[str] = None,
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
    (the item embeddings and knn_all), the second gives knn_1_2. Writes no
    artifact cache. -> (Retriever, BuildReport)."""
    dev = torch.device(device)
    names = list(w2vec)
    models = dict(models or {})
    if len(names) < 2:
        raise ValueError(f"build_retriever: two w2vec models, got {names}")
    unknown = sorted(set(models) - set(names))
    if unknown:
        raise ValueError(f"build_retriever: models {unknown} are not in w2vec {names}")
    seconds: Dict[str, float] = {}
    peak: Dict[str, int] = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()

    def lap(stage):
        nonlocal t
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            peak[stage] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
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

    # ---- C8 word2vec -------------------------------------------------------
    full = train.concat(test)
    trained = {}
    for name in names:
        if name in models:
            continue
        wcfg = w2vec[name]
        trainer = train_word2vec_device if wcfg.sampler == "device" else train_word2vec
        models[name] = trainer(full, wcfg, n_aids, device=dev)
        trained[name] = models[name].report
        log.info("w2vec %s: %s", name, trained[name])
        lap(f"w2vec {name}")

    # ---- C9 kNN -----------------------------------------------------------
    knns = {}
    for name in names:
        knns[name] = build_knn_tables(models[name], n_aids, dev)
        lap(f"knn {name}")
    co_nbr = tables["click_to_click"].neighbor.cpu().numpy()
    overlap = {}
    for name in names:
        overlap[name] = w2vec_covis_overlap(knns[name].neighbor.cpu().numpy(), co_nbr)
        log.info("w2vec overlap %s: %s", name, overlap[name])
        if report_dir is not None:
            write_overlap_report(
                os.path.join(report_dir, f"stats_w2vec_x_co_click-{name}.csv"),
                overlap[name])
    lap("overlap")

    # ---- C10 session embeddings --------------------------------------------
    aid_emb = torch.from_numpy(models[names[0]].embedding_by_aid(n_aids)).to(dev)
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
    return retriever, BuildReport(seconds, peak, covis_rep, trained, overlap, km, pop_rep)


def check_serving_features(tname: str, ranker: GBDTRanker) -> None:
    """A ranker scores retrieval's [S, C, F] features only if it was trained
    on FEATURE_NAMES, in that order."""
    if tuple(ranker.feature_names) != FEATURE_NAMES:
        raise ValueError(
            f"ranker '{tname}' was trained on {len(ranker.feature_names)} other "
            f"features, not retrieval's {len(FEATURE_NAMES)} FEATURE_NAMES")


def score_pass(
    retriever: Retriever, test: Events, rankers: Dict[str, object],
    batch_sessions: int,
) -> Dict[str, tuple]:
    """One scoring pass: retrieve, score all three targets per batch on the
    device, pull one stacked [3, S, 20] aid array per batch.
    -> {type name: (sessions [N] sorted, top-20 aids [N, 20])}."""
    for tname in TYPES:
        check_serving_features(tname, rankers[tname])
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
    independent re-parse of the CSV, logging a warning when they differ.
    -> the recall dict, or None without labels."""
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
        log.warning("submission re-parse mismatch: %s vs %s",
                    res2["total"], res["total"])
    return res


def load_rankers(work_dir: str) -> Dict[str, GBDTRanker]:
    """Read the three `ranker-gbdt-{clicks,carts,orders}.npz` files that a
    training run of either package wrote into its work dir; each must be
    a ranker over retrieval's FEATURE_NAMES."""
    rankers = {}
    for tname in TYPES:
        path = os.path.join(work_dir, f"ranker-gbdt-{tname}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no trained gbdt ranker for '{tname}' at {path}; "
                "run the pipeline with labels first to train rankers"
            )
        rankers[tname] = GBDTRanker.load(path)
        check_serving_features(tname, rankers[tname])
    return rankers


# ---------------------------------------------------------------------------
# training: pass A, the rankers, the streaming runner
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PassAReport:
    """What `pass_a` measured: wall seconds (ended by a device sync), test
    sessions and batches, seconds per phase (retrieval + device programs;
    host pulls, selection and row gathers; eval and persisting), and per
    target the downsampled rows and the sessions with a positive."""

    seconds: float
    sessions: int
    batches: int
    phases: Dict[str, float]
    rows: Dict[str, int]
    positive_sessions: Dict[str, int]


def _ranker_path(work_dir: str, tname: str) -> str:
    return os.path.join(work_dir, f"ranker-gbdt-{tname}.npz")


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
) -> Tuple[Dict[str, float], PassAReport]:
    """Training pass A over the test sessions, batch by batch on the
    retriever's device: the packed meta and the label bits (the label join
    on 45-bit keys), the per-source eval's counters, then on the host the
    downsample selection of every target (one numpy rng per type, seeded
    42, drawn only for batches with a positive; with
    ranker_cfg.device_select the keep bits come from the device instead)
    and one float16 row gather of the selected rows.

    Writes into work_dir `eval_retrieved.json` (the ceiling recall),
    `eval_retrieved_sources.json` (the per-source report),
    `passA-metrics.json`, and for each target not in skip_targets its rows
    as `downsampled-{t}.npz` (feats f16, y int8, session; session-sorted).
    -> (metrics: ceiling_{type,total}, cand_per_session_{mean,min,max};
    PassAReport)."""
    dev = retriever.ctx.aid_emb.device
    t0 = time.perf_counter()
    phases = {"retrieve + device programs": 0.0, "pulls + select + rows": 0.0,
              "eval + persist": 0.0}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    lab_keys = label_keys_device(labels, dev)
    rngs = {t: np.random.default_rng(42) for t in TYPES}
    rows = {t: [] for t in TYPES}
    dev_eval = None
    n_sessions = n_batches = 0
    t = sync()
    for b in retriever.iter_run(test, batch_sessions=batch_sessions):
        if ranker_cfg.device_select:
            gen = torch.Generator(device=dev).manual_seed(
                ranker_cfg.seed * 1_000_003 + n_batches)
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
        now = sync()
        phases["retrieve + device programs"] += now - t
        t = now

        b.unpack_meta(meta)
        tbits = tbits_d.cpu().numpy()
        sels = {}
        if ranker_cfg.device_select:
            for tname in TYPES:
                tid = TYPE2ID[tname]
                si, ci = np.nonzero((tbits >> (3 + tid)) & 1)
                if len(si):
                    sels[tname] = (si, ci, ((tbits[si, ci] >> tid) & 1).astype(np.float32))
        else:
            tgt = np.stack([(tbits >> ti) & 1 for ti in range(3)], axis=-1).astype(np.float32)
            for tname in TYPES:
                got = rank_engine.downsample_select(
                    b, tgt, TYPE2ID[tname], ranker_cfg, rngs[tname])
                if got is not None:
                    sels[tname] = got
        if sels:
            feats, _ = b.feats_rows_async(
                np.concatenate([s[0] for s in sels.values()]),
                np.concatenate([s[1] for s in sels.values()]))
            off = 0
            for tname, (si, _, y) in sels.items():
                rows[tname].append((feats[off: off + len(si)], y, b.session[si]))
                off += len(si)
        now = sync()
        phases["pulls + select + rows"] += now - t
        t = now
    if dev_eval is None:
        raise ValueError("pass A: no test sessions")

    report = dev_eval.finalize(labels)
    ceiling = report.pop("_ceiling")
    with open(os.path.join(work_dir, "eval_retrieved.json"), "w") as fh:
        json.dump(ceiling, fh, indent=2)
    with open(os.path.join(work_dir, "eval_retrieved_sources.json"), "w") as fh:
        json.dump(report, fh, indent=2)
    log.info("per-source recall:\n%s", format_report(report))
    metrics: Dict[str, float] = {
        f"ceiling_{k}": ceiling[k]["topall"] for k in ("clicks", "carts", "orders", "total")}
    anyc = report["_counts"]["src_any"]
    metrics["cand_per_session_mean"] = anyc["mean"]
    metrics["cand_per_session_min"] = anyc["min"]
    metrics["cand_per_session_max"] = anyc["max"]
    with open(os.path.join(work_dir, "passA-metrics.json"), "w") as fh:
        json.dump(metrics, fh, indent=2)

    # every target's rows persisted before any training: a crash in
    # training resumes from them
    n_rows, n_pos_sessions = {}, {}
    for tname in TYPES:
        parts, rows[tname] = rows[tname], None
        if tname in skip_targets:
            continue
        if not parts:
            raise ValueError(f"no positive sessions for {tname}")
        feats = np.concatenate([r[0] for r in parts])
        y = np.concatenate([r[1] for r in parts])
        sess = np.concatenate([r[2] for r in parts])
        order = np.argsort(sess, kind="stable")
        np.savez(_rows_path(work_dir, tname), feats=feats[order],
                 y=y[order].astype(np.int8), session=sess[order])
        n_rows[tname] = len(y)
        n_pos_sessions[tname] = int(np.unique(sess).size)
    phases["eval + persist"] = time.perf_counter() - t
    rep = PassAReport(time.perf_counter() - t0, n_sessions, n_batches, phases,
                      n_rows, n_pos_sessions)
    log.info("pass A: %s", rep)
    return metrics, rep


def train_ranker_cached(
    work_dir: str,
    tname: str,
    rows_fn: Callable[[], Tuple[np.ndarray, np.ndarray, np.ndarray]],
    gbdt_cfg: GBDTConfig,
    device,
    use_cache: bool = True,
) -> GBDTRanker:
    """One target's ranker: `ranker-gbdt-{t}.npz` from work_dir when cached;
    else rows_fn() -> (feats, y, sessions), the sessions split 75/25 in
    ascending id order into train / valid (no valid set with fewer than 8
    valid sessions), train_gbdt_ranker on `device`, then the ranker and its
    gain importance (`feat-importance-{t}.csv`) written to work_dir."""
    path = _ranker_path(work_dir, tname)
    if use_cache and os.path.exists(path):
        return GBDTRanker.load(path)
    feats, y, sess = rows_fn()
    u_sess = np.unique(sess)
    n_train = max(1, int(len(u_sess) * 0.75))
    valid = None
    if len(u_sess) - n_train >= 8:
        vmask = np.isin(sess, u_sess[n_train:])
        valid = (feats[vmask], y[vmask], sess[vmask])
        feats, y, sess = feats[~vmask], y[~vmask], sess[~vmask]
    ranker = train_gbdt_ranker(feats, y, sess, FEATURE_NAMES, gbdt_cfg,
                               valid=valid, device=device)
    ranker.save(path)
    imp = ranker.feature_importance("gain")
    with open(os.path.join(work_dir, f"feat-importance-{tname}.csv"), "w") as fh:
        fh.write("feature,gain_importance\n")
        for i in np.argsort(-imp):
            fh.write(f"{FEATURE_NAMES[i]},{imp[i]:.6g}\n")
    log.info("ranker %s: %d rows, valid ndcg %s", tname, len(y), ranker.eval_history)
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


def run_streaming(
    train: Events,
    test: Events,
    labels: Optional[Labels],
    n_aids: int,
    work_dir: str,
    device,
    cfg: Config = Config(),
    models: Optional[Dict[str, Word2Vec]] = None,
    batch_sessions: int = 512,
    use_cache: bool = True,
) -> Dict[str, float]:
    """The pipeline from events to recall@20 on `device`, as otto_tpu's
    Pipeline.run_streaming: check_work_dir, build_retriever (training the
    models of cfg.w2vec that `models` does not hold), then with labels
    pass_a, the three rankers (train_ranker_cached) and pass B
    (score_pass) -> submit_and_eval; without labels, the rankers in
    work_dir score pass B.

    Crash-resume: with use_cache, when `passA-metrics.json` and, for every
    target, its ranker or its persisted rows are in work_dir, pass A is
    skipped and the missing rankers train from the rows.
    -> metrics: pass A's and recall@20 per type and total ({} without
    labels)."""
    if cfg.ranker_backend != "gbdt":
        raise NotImplementedError(
            f"ranker backend {cfg.ranker_backend!r}: the MLP ranker is not ported yet "
            "(ROADMAP Queue 1, \"The MLP ranker\"); use 'gbdt'")
    check_work_dir(work_dir, cfg, n_aids, use_cache)
    retriever, _ = build_retriever(
        train, test, n_aids, device, cfg.w2vec, models, cfg.covis, cfg.popularity,
        cfg.retrieval, cfg.kmeans, report_dir=work_dir)
    if labels is None:
        preds = score_pass(retriever, test, load_rankers(work_dir), batch_sessions)
        submit_and_eval(work_dir, preds, None)
        return {}

    pm_path = os.path.join(work_dir, "passA-metrics.json")
    have_ranker = {t: use_cache and os.path.exists(_ranker_path(work_dir, t))
                   for t in TYPES}
    if use_cache and os.path.exists(pm_path) and all(
            have_ranker[t] or os.path.exists(_rows_path(work_dir, t)) for t in TYPES):
        with open(pm_path) as fh:
            metrics = json.load(fh)
        log.info("pass A cached in %s", work_dir)
    else:
        metrics, _ = pass_a(retriever, test, labels, cfg.ranker, work_dir, batch_sessions,
                            skip_targets=[t for t in TYPES if have_ranker[t]])
    rankers = {
        t: train_ranker_cached(work_dir, t, lambda t=t: load_downsampled(work_dir, t),
                               cfg.gbdt, device, use_cache)
        for t in TYPES
    }
    preds = score_pass(retriever, test, rankers, batch_sessions)
    metrics.update(submit_and_eval(work_dir, preds, labels))
    return metrics
