"""Carry otto_tpu's tables and models across to the port.

The port can take what otto_tpu built or trained (its word2vec models,
tables and rankers, and the MLP tower's initial weights, for tests):
otto_tpu's
numpy (or jax) arrays become tensors on an explicit device, or the port's
host containers. Arrays are read with
`np.asarray`, so jax arrays work too, and the port never imports jax
itself.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from otto_tpu_torch.config import GBDTConfig, Word2VecConfig
from otto_tpu_torch.engine.covis import CoVisTables
from otto_tpu_torch.engine.retrieval import RetrievalContext
from otto_tpu_torch.models.gbdt import GBDTRanker
from otto_tpu_torch.models.ranker import RankerTower
from otto_tpu_torch.models.word2vec import Vocab, Word2Vec


def _t(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype), device=device)


def covis_from_numpy(covis: Sequence, device) -> Tuple[CoVisTables, ...]:
    """The five co-visitation tables in COVIS_NAMES order (each a 5-tuple of
    [A, N] arrays) -> the port's CoVisTables on `device`."""
    dev = torch.device(device)
    return tuple(CoVisTables(*(_t(a, np.int32, dev) for a in tabs)) for tabs in covis)


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

    covis: as for covis_from_numpy; knn_all / knn_1_2: KnnTables or
    (neighbor, dist) pairs; pop_cl50: the 50-cluster PopularityTables
    (candidate, ranks are read); pop_cl1: the 1-cluster PopularityTables
    (aid_rank is read); aid_emb: [A, D] item embeddings."""
    dev = torch.device(device)
    i32, f32 = np.int32, np.float32
    return RetrievalContext(
        covis=covis_from_numpy(covis, dev),
        knn_all=(_t(knn_all[0], i32, dev), _t(knn_all[1], f32, dev)),
        knn_1_2=(_t(knn_1_2[0], i32, dev), _t(knn_1_2[1], f32, dev)),
        pop_cl50_cand=_t(pop_cl50.candidate, i32, dev),
        pop_cl50_ranks=_t(pop_cl50.ranks, i32, dev),
        pop_cl1_rank=_t(pop_cl1.aid_rank, i32, dev),
        aid_emb=_t(aid_emb, f32, dev),
    )


def word2vec_from_numpy(ref) -> Word2Vec:
    """An otto_tpu Word2Vec (its numpy vocab and emb) -> the port's."""
    cfg = Word2VecConfig(**{f.name: getattr(ref.cfg, f.name)
                            for f in dataclasses.fields(Word2VecConfig)})
    v = ref.vocab
    return Word2Vec(
        cfg=cfg,
        vocab=Vocab(np.asarray(v.aid_of_word, np.int32),
                    np.asarray(v.word_of_aid, np.int32),
                    np.asarray(v.counts, np.int64)),
        emb=np.asarray(ref.emb, np.float32),
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


def ranker_from_numpy(params) -> RankerTower:
    """otto_tpu's RankerParams (norm stats, (w, b) per layer, src_idx or
    None) -> the port's RankerTower on the CPU, its own copy of them."""
    return RankerTower(
        params.norm_mean, params.norm_std,
        [(np.asarray(w), np.asarray(b)) for w, b in params.weights],
        None if params.src_idx is None else np.asarray(params.src_idx),
    )
