"""The serving functions of the pipeline.

Counterpart of otto_tpu/pipeline/runner.py's scoring pass and tail:
re-retrieve the test sessions, score every batch with the three target
rankers on the device, keep the top-20 per target, write the submission
file and evaluate recall@20. A plain loop: the batches run one after the
other on the device's stream.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from otto_tpu_torch.config import TYPES
from otto_tpu_torch.data.schema import Events, Labels
from otto_tpu_torch.engine import rank as rank_engine
from otto_tpu_torch.engine.retrieval import Retriever
from otto_tpu_torch.eval.recall import evaluate_topk
from otto_tpu_torch.models.gbdt import GBDTRanker


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
