"""Carry otto_tpu's tables and models across to the port.

Until the table-building stages and GBDT training are ported, the port
serves with what otto_tpu built: its numpy (or jax) arrays become tensors on an
explicit device. Arrays are read with `np.asarray`, so jax arrays work too,
and the port never imports jax itself.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from otto_tpu_torch.config import GBDTConfig
from otto_tpu_torch.engine.covis import CoVisTables
from otto_tpu_torch.engine.retrieval import RetrievalContext
from otto_tpu_torch.models.gbdt import GBDTRanker


def _t(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype), device=device)


def context_from_numpy(
    covis: Sequence,
    knn_all,
    knn_1_2,
    pop_cl50,
    pop_cl1,
    aid_emb,
    device,
) -> RetrievalContext:
    """otto_tpu's retrieval tables -> a port RetrievalContext on `device`.

    covis: the five CoVisTables in COVIS_NAMES order (each a 5-tuple of
    [A, N] arrays); knn_all / knn_1_2: KnnTables or (neighbor, dist)
    pairs; pop_cl50: the 50-cluster PopularityTables (candidate, ranks are
    read); pop_cl1: the 1-cluster PopularityTables (aid_rank is read);
    aid_emb: [A, D] item embeddings."""
    dev = torch.device(device)
    i32, f32 = np.int32, np.float32
    return RetrievalContext(
        covis=tuple(CoVisTables(*(_t(a, i32, dev) for a in tabs)) for tabs in covis),
        knn_all=(_t(knn_all[0], i32, dev), _t(knn_all[1], f32, dev)),
        knn_1_2=(_t(knn_1_2[0], i32, dev), _t(knn_1_2[1], f32, dev)),
        pop_cl50_cand=_t(pop_cl50.candidate, i32, dev),
        pop_cl50_ranks=_t(pop_cl50.ranks, i32, dev),
        pop_cl1_rank=_t(pop_cl1.aid_rank, i32, dev),
        aid_emb=_t(aid_emb, f32, dev),
    )


def gbdt_from_numpy(ref) -> GBDTRanker:
    """An otto_tpu GBDTRanker (its numpy arrays) -> the port's GBDTRanker."""
    gains = getattr(ref, "gains", None)
    return GBDTRanker(
        cfg=GBDTConfig.from_dict(dataclasses.asdict(ref.cfg)),
        edges=np.asarray(ref.edges, np.float32),
        gfeat=np.asarray(ref.gfeat, np.int32),
        thr=np.asarray(ref.thr, np.int32),
        leaf=np.asarray(ref.leaf, np.float32),
        feature_names=tuple(ref.feature_names),
        gains=None if gains is None else np.asarray(gains),
        best_iter=int(ref.best_iter),
        best_score=float(ref.best_score),
    )
