"""The card's published peaks and the work the kernels and rankers need.

Peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet, dense, at the
700 W limit): HBM3 at 3.35 TB/s; 67 TFLOP/s in FP64 on the tensor cores;
67 TFLOP/s in FP32 outside the tensor cores. A card set below 700 W runs
slower under load: the run prints its power limit beside every share.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP64_TENSOR_FLOPS = 67e12
FP32_FLOPS = 67e12


def k1_bytes(B: int, S: int, P: int, W: int) -> int:
    """K1 (ops/kernels/gather.py) gathers [B, S, W] from B [S, P] int32 or
    float32 columns through one [S, W] int32 index: each column and the
    index read once, the output written once."""
    return 4 * (B * S * P + S * W + B * S * W)


def k2_bytes(B: int, S: int, P: int) -> int:
    """K2 (ops/kernels/segscan.py) scans [B, S, P] 4-byte values under
    [S, P] one-byte segment flags into [B, S, P]."""
    return 4 * B * S * P + S * P + 4 * B * S * P


def gbdt_ops(rows: int, n_trees: int, depth: int) -> int:
    """One comparison a level and one leaf add a tree, per scored row."""
    return rows * n_trees * (depth + 1)


def mlp_flops(rows: int, dims) -> int:
    """The tower's matrix products: 2 * in * out a layer, per scored row."""
    return rows * sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
