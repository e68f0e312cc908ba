"""The plain reference of the serving path's scoring and top-k.

`gbdt_scores` is a frozen copy of `_bin_program` and
`_predict_binned_program` of `otto_tpu_torch/models/gbdt.py` at commit
7f160d3, with `torch.gather` for kernel K1; `mlp_scores` of
`RankerTower.forward` of `otto_tpu_torch/models/ranker.py` (pointwise, no
dropout); `topk` of `_topk_program` of `otto_tpu_torch/engine/rank.py`.
Each takes the raw arrays of gen/rankers.py.

`precision` selects the control of benchmark/PERF.md: "full" is the
configuration's arithmetic (float32 features compared with float32 bin
edges; the tower's bfloat16 operands summed in float64); "low" is the
nearest precision below it (features rounded to bfloat16 before they are
binned; the tower's operands in float8 e4m3 instead of bfloat16).
"""
from __future__ import annotations

from typing import Dict

import torch

F32 = torch.float32
F64 = torch.float64
BF16 = torch.bfloat16
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def _on(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device, dtype=dtype)


def gbdt_scores(feats: torch.Tensor, arrays: Dict, precision: str = "full") -> torch.Tensor:
    """feats [M, F] float32 -> scores [M] float32."""
    dev = feats.device
    x = feats.to(BF16).to(F32) if precision == "low" else feats
    edges = _on(arrays["edges"], dev, F32)
    gfeat, thr = _on(arrays["gfeat"], dev, torch.int32), _on(arrays["thr"], dev, torch.int32)
    leaf = _on(arrays["leaf"], dev, F32)
    bins = torch.searchsorted(edges.contiguous(), x.t().contiguous(), right=True)
    bins = bins.to(torch.int32).t().contiguous()
    M = bins.shape[0]
    T, depth, W = gfeat.shape
    n_leaves = leaf.shape[1]
    tree = torch.arange(T, device=dev, dtype=torch.int32)[None, :]
    node = torch.zeros((M, T), dtype=torch.int32, device=dev)
    for level in range(depth):
        at = (tree * W + node).long()
        f = gfeat[:, level, :].reshape(-1)[at]
        t_thr = thr[:, level, :].reshape(-1)[at]
        b = torch.gather(bins, 1, f.long())
        node = node * 2 + (b >= t_thr).to(torch.int32)
    val = leaf.reshape(-1)[(tree * n_leaves + node).long()]
    return val.sum(dim=1)


def _operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A product operand as the tower rounds it, returned in float64."""
    if precision == "low":
        return x.clamp(-FP8_MAX, FP8_MAX).to(FP8).to(F64)
    return x.to(BF16).to(F64)


def mlp_scores(feats: torch.Tensor, arrays: Dict, precision: str = "full") -> torch.Tensor:
    """feats [M, F] float32 -> scores [M] float32."""
    dev = feats.device
    x64 = feats.to(F64)
    x = (torch.sign(x64) * torch.log1p(torch.abs(x64))).to(F32)
    x = (x - _on(arrays["norm_mean"], dev, F32)) / _on(arrays["norm_std"], dev, F32)
    n = len(arrays["weights"])
    for i, (w, b) in enumerate(arrays["weights"]):
        w = _on(w, dev, F32)
        b = _on(b, dev, F32)
        x = (torch.matmul(_operand(x, precision), _operand(w, precision)) + b.to(F64)).to(F32)
        if i < n - 1:
            x = torch.relu(x)
    return x[..., 0]


def scores(backend: str, feats: torch.Tensor, arrays: Dict, precision: str = "full"):
    fn = gbdt_scores if backend == "gbdt" else mlp_scores
    return fn(feats, arrays, precision)


def topk(scores: torch.Tensor, cand: torch.Tensor, k: int):
    """Top-k of scores [S, C] among the valid candidates (cand >= 0), ties
    to the lower candidate index (a stable descending sort); slots past
    the valid candidates get aid -1."""
    s = torch.where(cand >= 0, scores, -torch.inf)
    top_s, idx = torch.sort(s, dim=1, descending=True, stable=True)
    top_s, idx = top_s[:, :k], idx[:, :k]
    top_a = torch.gather(cand, 1, idx)
    return top_s, torch.where(torch.isfinite(top_s), top_a, -1)
