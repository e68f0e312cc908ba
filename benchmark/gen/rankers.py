"""Rankers of the serving cells, drawn from the seed: no training.

GBDT: trees of the configuration's shape (`n_trees`, depth D, `n_bins`
bins over the 104 features) with random valid splits and leaves. Bin
edges are drawn per feature on a log scale that spans what the features
hold (small counts and ranks, distances, seconds, shares x 10,000), so
every level splits real rows both ways. MLP: towers of the configuration's
widths with He-normal weights, small biases and normalisation statistics
in the range of the log-squashed features. Both are drawn on the device
by one torch.Generator and pulled as plain numpy arrays, from which the
harness makes the port's rankers and the reference scores.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def gbdt_arrays(n_features: int, n_trees: int, depth: int, n_bins: int,
                g: torch.Generator) -> Dict[str, np.ndarray]:
    """edges [F, n_bins - 1] ascending float32, gfeat / thr [T, D, W]
    int32 (thr in [1, n_bins]; n_bins is the no-op split), leaf [T, 2^D]
    float32."""
    W = 2 ** (depth - 1)
    n_edges = n_bins - 1
    n_small = n_edges // 3
    dev = g.device
    small = torch.arange(n_small, dtype=torch.float32, device=dev) - 1.5          # -1.5 .. around 19.5
    mag = 10.0 ** (torch.rand((n_features, n_edges - n_small), generator=g, device=dev) * 7.0 - 2.0)
    sign = torch.where(torch.rand(mag.shape, generator=g, device=dev) < 0.1, -1.0, 1.0)
    edges = torch.cat([small.expand(n_features, -1), sign * mag], dim=1)
    edges = torch.sort(edges, dim=1).values
    gfeat = torch.randint(0, n_features, (n_trees, depth, W), generator=g, device=dev, dtype=torch.int32)
    thr = torch.randint(1, n_bins + 1, (n_trees, depth, W), generator=g, device=dev, dtype=torch.int32)
    leaf = 0.1 * torch.randn((n_trees, 2 ** depth), generator=g, device=dev)
    return {"edges": edges.cpu().numpy().astype(np.float32), "gfeat": gfeat.cpu().numpy(),
            "thr": thr.cpu().numpy(), "leaf": leaf.cpu().numpy().astype(np.float32)}


def mlp_arrays(n_features: int, hidden: List[int], g: torch.Generator) -> Dict[str, object]:
    """norm_mean / norm_std [F] float32 and weights [(w [in, out], b
    [out])] float32, the tower's layout."""
    dev = g.device
    dims = [n_features, *hidden, 1]
    weights = []
    for i in range(len(dims) - 1):
        w = torch.randn((dims[i], dims[i + 1]), generator=g, device=dev) * (2.0 / dims[i]) ** 0.5
        b = 0.01 * torch.randn((dims[i + 1],), generator=g, device=dev)
        weights.append((w.cpu().numpy().astype(np.float32), b.cpu().numpy().astype(np.float32)))
    mean = torch.rand((n_features,), generator=g, device=dev) * 6.0 - 1.0
    std = torch.rand((n_features,), generator=g, device=dev) * 2.5 + 0.5
    return {"norm_mean": mean.cpu().numpy().astype(np.float32),
            "norm_std": std.cpu().numpy().astype(np.float32), "weights": weights}


def ranker_arrays(cfg: dict, n_features: int, seed: int, device) -> List[Dict[str, object]]:
    """One ranker's arrays per target type, from one generator on
    `device`."""
    g = torch.Generator(device=torch.device(device)).manual_seed(seed)
    r = cfg["ranker"]
    out = []
    for _ in range(r["n_rankers"]):
        if cfg["ranker_backend"] == "gbdt":
            out.append(gbdt_arrays(n_features, r["n_trees"], r["max_depth"], r["n_bins"], g))
        else:
            out.append(mlp_arrays(n_features, r["hidden_dims"], g))
    return out
