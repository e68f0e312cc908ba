"""K5: a GBDT ranker's scores from the raw features, in one kernel.

feats [M, F] float32, the ranker's edges [F, B - 1] float32 (ascending a
feature), gfeat / thr [T, D, 2^(D-1)] int32 and leaf [T, 2^D] float32 ->
scores [M] float32: every row binned, walked through all T trees and its
leaves summed, without materialising bins or per-level [M, T] tensors.
The CUDA kernel is `otto_tpu_torch/csrc/gbdt_walk.cu`; its plain twin is
`models/gbdt.py::_predict_program` (`_bin_program` then
`_predict_binned_program`), which `GBDTRanker.predict_scores_device`
runs for a CPU tensor. `gbdt_walk` takes CUDA tensors only and raises on
anything else.

The kernel decides each split without the bin: `bin(x, f) >= thr` exactly
when `thr <= B - 1` and `!(edges[f, thr - 1] > x)`, which
tests/test_torch_gbdt_walk.py holds to `_bin_program`. It sums the leaves in
float64 (`leaf_sum_order`) and rounds once to float32: within half a
float32 ulp of the exact sum, where the twin's float32 sum drifts by its
order.
"""
from __future__ import annotations

import torch

from otto_tpu_torch.ops.kernels import _build
from otto_tpu_torch.utils import timing

# kernel launches since the last reset (see gather.LAUNCHES)
LAUNCHES = timing.counter("otto::kernels.gbdt_walk")

# rows a tile (gbdt_walk.cu ROWS), and threads a row, each walking a
# contiguous part of the trees (PARTS)
ROWS = 128
PARTS = 4
# dynamic shared memory of one block on sm_90 (gbdt_walk.cu SMEM_MAX)
SMEM_BYTES = 232448


def smem_bytes(F: int, T: int, D: int) -> int:
    """Shared memory of one block (gbdt_walk.cu `otto_gbdt_walk_smem`): the
    float64 sums of parts 1.. of each row, a tile of ROWS rows at an odd
    stride with one spare column, the T trees' 2^D - 1 split nodes (8
    bytes each) and 2^D leaves."""
    S = (F + 1) | 1
    return 8 * ROWS * (PARTS - 1) + 4 * ROWS * S + 8 * T * (2 ** D - 1) + 4 * T * 2 ** D


def leaf_sum_order(T: int):
    """The kernel's order of the leaf sum: PARTS runs of consecutive trees
    (ceil(T / PARTS) each, the last ones shorter or empty), each summed in
    float64 in tree order from 0.0, then the runs' sums added in run
    order. -> [(first tree, end)] of each run."""
    per = -(-T // PARTS)
    return [(min(T, p * per), min(T, (p + 1) * per)) for p in range(PARTS)]


def _check(feats, edges, gfeat, thr, leaf):
    tensors = {"feats": feats, "edges": edges, "gfeat": gfeat, "thr": thr, "leaf": leaf}
    want = {"feats": torch.float32, "edges": torch.float32, "gfeat": torch.int32,
            "thr": torch.int32, "leaf": torch.float32}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"gbdt_walk: {name} is not a tensor")
        if t.dtype != want[name]:
            raise TypeError(f"gbdt_walk: {name} is {t.dtype}, want {want[name]}")
    if feats.dim() != 2 or edges.dim() != 2 or gfeat.dim() != 3 or leaf.dim() != 2:
        raise ValueError(
            f"gbdt_walk: feats {tuple(feats.shape)}, edges {tuple(edges.shape)}, gfeat "
            f"{tuple(gfeat.shape)}, leaf {tuple(leaf.shape)} are not [M, F], [F, B-1], "
            "[T, D, W], [T, 2^D]")
    M, F = feats.shape
    T, D, W = gfeat.shape
    if F < 1 or T < 1 or D < 1 or D > 16:
        raise ValueError(f"gbdt_walk: F = {F}, T = {T}, D = {D}: the kernel takes "
                         "F >= 1, T >= 1, 1 <= D <= 16")
    if (edges.shape[0] != F or W != 2 ** (D - 1) or thr.shape != gfeat.shape
            or leaf.shape != (T, 2 ** D)):
        raise ValueError(
            f"gbdt_walk: feats [M, {F}], edges {tuple(edges.shape)}, gfeat / thr "
            f"{tuple(gfeat.shape)} / {tuple(thr.shape)}, leaf {tuple(leaf.shape)} do not "
            "form one ranker (edges [F, B-1], gfeat = thr [T, D, 2^(D-1)], leaf [T, 2^D])")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"gbdt_walk: {name} is not contiguous")
    need = smem_bytes(F, T, D)
    if need > SMEM_BYTES:
        raise ValueError(f"gbdt_walk: F = {F}, T = {T}, D = {D} need {need} bytes of "
                         f"shared memory, above the {SMEM_BYTES} a block has")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"gbdt_walk: tensors on more than one device: {sorted(map(str, devices))}")
    if feats.device.type != "cuda":
        raise ValueError(f"gbdt_walk: no kernel for {feats.device} (the plain twin is "
                         "models/gbdt.py::_predict_program)")


def gbdt_walk(feats: torch.Tensor, edges: torch.Tensor, gfeat: torch.Tensor,
              thr: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """One launch on the current stream: scores [M] float32. Every tensor
    contiguous, on one CUDA device; the ranker's trees and a tile of rows
    must fit a block's shared memory (`smem_bytes` <= SMEM_BYTES)."""
    _check(feats, edges, gfeat, thr, leaf)
    M, F = feats.shape
    T, D, _ = gfeat.shape
    out = torch.empty((M,), dtype=torch.float32, device=feats.device)
    if M == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.otto_gbdt_walk(feats.data_ptr(), edges.data_ptr(), gfeat.data_ptr(),
                                 thr.data_ptr(), leaf.data_ptr(), out.data_ptr(),
                                 M, F, edges.shape[1], T, D, stream)
    _build.check(err, "gbdt_walk")
    LAUNCHES.add()   # the pipelined runners launch from two threads
    return out
