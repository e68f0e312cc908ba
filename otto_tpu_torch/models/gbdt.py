"""Histogram-GBDT lambdarank ranker: the predict half.

Counterpart of otto_tpu/models/gbdt.py for scoring. Trees are dense
arrays: split feature gfeat [T, D, W] and split bin thr [T, D, W] (thr ==
n_bins is a no-op split that sends every row left), leaf values
leaf [T, 2^D], W = 2^(D-1). Training stays in otto_tpu for now; `load`
reads the `.npz` that otto_tpu's `GBDTRanker.save` writes. A ranker is
checked when it is made: K1 reads the split features' bins unchecked, so
a split feature out of range would read out of bounds on the card.

Prediction bins the raw features (bin = number of edges <= x), then walks
all trees at once: node state is [M, T], and at every level the per-row
feature-bin fetch is ONE row gather [M, F] -> [M, T] on kernel K1.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from otto_tpu_torch.config import GBDTConfig
from otto_tpu_torch.engine.retrieval import FEATURE_NAMES
from otto_tpu_torch.ops.kernels.gather import gather_rows


def _bin_program(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """x [M, F] f32, edges [F, B-1] ascending -> [M, F] int32 bin ids, the
    count of edges <= x per feature (otto_tpu's `_bin_program`, whose
    edges come ascending from `compute_bin_edges`, +inf padded)."""
    b = torch.searchsorted(edges.contiguous(), x.t().contiguous(), right=True)
    # row-major, as K1 reads it at every level of the walk
    return b.to(torch.int32).t().contiguous()


def _predict_binned_program(
    bins: torch.Tensor, gfeat: torch.Tensor, thr: torch.Tensor, leaf: torch.Tensor
) -> torch.Tensor:
    """bins [M, F] int32; gfeat/thr [T, D, W] int32, leaf [T, 2^D] f32 ->
    scores [M] f32."""
    M = bins.shape[0]
    T, depth, W = gfeat.shape
    n_leaves = leaf.shape[1]
    tree = torch.arange(T, device=bins.device, dtype=torch.int32)[None, :]
    node = torch.zeros((M, T), dtype=torch.int32, device=bins.device)
    for level in range(depth):
        # this level's (feature, threshold) of each row's node in each tree
        at = (tree * W + node).long()
        f = gfeat[:, level, :].reshape(-1)[at]
        t_thr = thr[:, level, :].reshape(-1)[at]
        b = gather_rows(bins[None], f)[0]
        node = node * 2 + (b >= t_thr).to(torch.int32)
    val = leaf.reshape(-1)[(tree * n_leaves + node).long()]
    return val.sum(dim=1)


def _predict_program(x, edges, gfeat, thr, leaf) -> torch.Tensor:
    """Fused bin + traverse: raw features [M, F] f32 -> scores [M]."""
    return _predict_binned_program(_bin_program(x, edges), gfeat, thr, leaf)


@dataclasses.dataclass
class GBDTRanker:
    """Trained GBDT lambdarank model. The numpy arrays are the model as
    otto_tpu saves it; the tensor copies used for scoring are made per
    device on first use."""

    cfg: GBDTConfig
    edges: np.ndarray        # [F, B-1] bin edges
    gfeat: np.ndarray        # [T, D, W] split feature (global id)
    thr: np.ndarray          # [T, D, W] split bin threshold (n_bins = no-op)
    leaf: np.ndarray         # [T, 2^D] leaf values
    feature_names: Tuple[str, ...]
    gains: Optional[np.ndarray] = None  # [T, D, W] split gains (0 = no-op)
    best_iter: int = -1
    best_score: float = float("nan")
    _on_device: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    def __post_init__(self):
        T = np.shape(self.gfeat)[0]
        D, n_bins = self.cfg.max_depth, self.cfg.n_bins
        F = len(FEATURE_NAMES)
        if tuple(self.feature_names) != FEATURE_NAMES:
            raise ValueError("ranker features differ from retrieval's FEATURE_NAMES")
        shapes = {"edges": (F, n_bins - 1), "gfeat": (T, D, 2 ** (D - 1)),
                  "thr": (T, D, 2 ** (D - 1)), "leaf": (T, 2 ** D)}
        for name, want in shapes.items():
            if np.shape(getattr(self, name)) != want:
                raise ValueError(f"ranker {name} has shape "
                                 f"{np.shape(getattr(self, name))}, want {want}")
        gfeat, thr = np.asarray(self.gfeat), np.asarray(self.thr)
        if gfeat.size and not (gfeat.min() >= 0 and gfeat.max() < F):
            raise ValueError(f"ranker split features outside [0, {F})")
        # thr == n_bins is the no-op split
        if thr.size and not (thr.min() >= 1 and thr.max() <= n_bins):
            raise ValueError(f"ranker split bins outside [1, {n_bins}]")

    def tensors(self, device: torch.device):
        """(edges f32, gfeat i32, thr i32, leaf f32) on `device`, cached."""
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = (
                torch.as_tensor(np.asarray(self.edges, np.float32), device=device),
                torch.as_tensor(np.asarray(self.gfeat, np.int32), device=device),
                torch.as_tensor(np.asarray(self.thr, np.int32), device=device),
                torch.as_tensor(np.asarray(self.leaf, np.float32), device=device),
            )
        return self._on_device[key]

    def predict_scores_device(self, feats: torch.Tensor) -> torch.Tensor:
        """feats [..., F] on a device -> scores [...] on the same device."""
        shape = feats.shape[:-1]
        flat = feats.reshape(-1, feats.shape[-1]).to(torch.float32)
        scores = _predict_program(flat, *self.tensors(feats.device))
        return scores.reshape(shape)

    @staticmethod
    def load(path: str) -> "GBDTRanker":
        """Read the `.npz` written by otto_tpu's GBDTRanker.save."""
        z = np.load(path, allow_pickle=False)
        cfg = GBDTConfig.from_dict(
            ast.literal_eval(bytes(z["cfg"].tobytes()).decode()))
        gains = z["gains"] if "gains" in z.files else np.zeros((0,), np.float32)
        best = z["best"] if "best" in z.files else np.array([-1.0, np.nan])
        return GBDTRanker(
            cfg=cfg,
            edges=z["edges"],
            gfeat=z["gfeat"],
            thr=z["thr"],
            leaf=z["leaf"],
            gains=gains if gains.size else None,
            feature_names=tuple(z["feature_names"].tolist()),
            best_iter=int(best[0]),
            best_score=float(best[1]),
        )
