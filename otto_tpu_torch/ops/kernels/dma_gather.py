"""K4: table row gather, `out[i] = table[clip(ids[i], 0, V - 1)]`.

table [V, D] float32 | int32, ids [N] int32 -> [N, D]. Serves the session
embeddings' row gather. The CUDA kernel is
`otto_tpu_torch/csrc/gather_rows_hbm.cu`; `gather_rows_hbm_ref` is its
plain PyTorch twin, to which the kernel is bit-equal. A CPU tensor goes to
the twin, a CUDA tensor to the kernel.
"""
from __future__ import annotations

import torch

from otto_tpu_torch.ops.kernels import _build

# kernel launches since the last reset (see gather.launches)
launches = 0

_DTYPES = (torch.int32, torch.float32)


def _check(table, ids):
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError(
            f"gather_rows_hbm: table {tuple(table.shape)} / ids "
            f"{tuple(ids.shape)} are not [V, D] / [N]"
        )
    if table.dtype not in _DTYPES or ids.dtype != torch.int32:
        raise TypeError(
            f"gather_rows_hbm: table {table.dtype} (int32|float32), ids "
            f"{ids.dtype} (int32)"
        )
    if table.device != ids.device:
        raise ValueError("gather_rows_hbm: table and ids on different devices")
    if table.shape[0] == 0 and ids.numel():
        raise IndexError("gather_rows_hbm: gather from an empty table")
    if table.shape[0] >= 2**31:
        raise ValueError("gather_rows_hbm: V must stay below 2^31")


def gather_rows_hbm_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain twin: `index_select` of the clamped ids."""
    _check(table, ids)
    return table.index_select(0, ids.clamp(0, table.shape[0] - 1).long())


def gather_rows_hbm(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    _check(table, ids)
    if table.device.type == "cpu":
        return gather_rows_hbm_ref(table, ids)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows_hbm: no kernel for {table.device}")
    table = table.contiguous()
    ids = ids.contiguous()
    V, D = table.shape
    N = ids.shape[0]
    out = torch.empty((N, D), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.otto_gather_rows_hbm(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), N, V, D, stream,
        )
    _build.check(err, "gather_rows_hbm")
    global launches
    launches += 1
    return out
