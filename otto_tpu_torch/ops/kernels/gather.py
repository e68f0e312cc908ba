"""K1: batched row-wise gather `out[b, s, w] = values[b][s, idx[s, w]]`.

B columns of one 4-byte dtype share one row-local index map; the index
width W may differ from the row width P (the GBDT twin's tree walk, which
GBDT training runs on the card for its validation scores, gathers T = 150
tree-bin columns from F = 104 feature columns). The columns come
either stacked, one [B, S, P] tensor, or as a sequence of B [S, P]
tensors, which the kernel reads by pointer without stacking them. The
CUDA kernel is `otto_tpu_torch/csrc/gather_rows.cu`; `gather_rows_ref` is
its plain PyTorch twin. A CPU tensor goes to the twin, a CUDA tensor to
the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple, Union

import torch

from otto_tpu_torch.ops.kernels import _build
from otto_tpu_torch.utils import timing

# kernel launches since the last reset (chip_smoke.py resets it before
# the main path and reads it after)
LAUNCHES = timing.counter("otto::kernels.gather_rows")

_DTYPES = (torch.int32, torch.float32)
# column pointers one launch takes (gather_rows.cu MAX_COLS)
MAX_COLS = 256
# dynamic shared memory of one block on sm_90 (gather_rows.cu SMEM_MAX):
# the kernel needs at least one source row and one index row in it
SMEM_BYTES = 232448

Columns = Union[torch.Tensor, Sequence[torch.Tensor]]


def _round16(n: int) -> int:
    return (n + 15) & ~15


def _shape(values: Columns) -> Tuple[int, int, int, torch.dtype, torch.device]:
    """-> (B, S, P, dtype, device) of either form; raises on a form, a mix
    of dtypes or devices the kernel does not take."""
    if isinstance(values, torch.Tensor):
        if values.dim() != 3:
            raise ValueError(f"gather_rows: values {tuple(values.shape)} are not [B, S, P]")
        return (*values.shape, values.dtype, values.device)
    cols = list(values)
    if not cols:
        raise ValueError("gather_rows: an empty column list has no shape")
    first = cols[0]
    if any(not isinstance(c, torch.Tensor) or c.dim() != 2 or c.shape != first.shape
           for c in cols):
        raise ValueError("gather_rows: columns are not tensors of one [S, P] shape")
    if any(c.dtype != first.dtype for c in cols):
        raise TypeError("gather_rows: columns of more than one dtype: "
                        f"{sorted({str(c.dtype) for c in cols})}")
    if any(c.device != first.device for c in cols):
        raise ValueError("gather_rows: columns on more than one device")
    return (len(cols), *first.shape, first.dtype, first.device)


def gather_rows_ref(values: Columns, idx: torch.Tensor) -> torch.Tensor:
    """Plain twin: `torch.gather` on the stack (a column list is stacked)."""
    if not isinstance(values, torch.Tensor):
        values = torch.stack(list(values))
    B = values.shape[0]
    ix = idx.long().unsqueeze(0).expand(B, -1, -1)
    return torch.gather(values, 2, ix)


def gather_rows(values: Columns, idx: torch.Tensor, check: bool = False) -> torch.Tensor:
    """values [B, S, P] int32 | float32, or a sequence of B [S, P] tensors
    of one such dtype and device; idx [S, W] int32 in [0, P) -> [B, S, W].
    B is at most MAX_COLS, and one source row and one index row must fit
    a block's shared memory (16 + P and W words each rounded up to 16
    bytes <= SMEM_BYTES). `check=True` verifies the index range first (one
    device sync; the kernel itself does not bound-check)."""
    B, S, P, dtype, device = _shape(values)
    if idx.dim() != 2 or idx.shape[0] != S:
        raise ValueError(f"gather_rows: values {(B, S, P)} / idx {tuple(idx.shape)} "
                         "are not [B, S, P] / [S, W]")
    if dtype not in _DTYPES or idx.dtype != torch.int32:
        raise TypeError(f"gather_rows: values {dtype} (int32|float32), idx {idx.dtype} (int32)")
    if device != idx.device:
        raise ValueError("gather_rows: values and idx on different devices")
    W = idx.shape[1]
    if B > MAX_COLS:
        raise ValueError(f"gather_rows: {B} columns, above the kernel's {MAX_COLS} "
                         "column pointers")
    need = 16 + _round16(4 * P) + _round16(4 * W)
    if need > SMEM_BYTES:
        raise ValueError(f"gather_rows: one source row (P = {P}) and one index row "
                         f"(W = {W}) need {need} bytes of shared memory, above the "
                         f"{SMEM_BYTES} a block has")
    if check and idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= P):
        raise IndexError(f"gather_rows: index outside [0, {P})")
    if device.type == "cpu":
        return gather_rows_ref(values, idx)
    if device.type != "cuda":
        raise ValueError(f"gather_rows: no kernel for {device}")
    if isinstance(values, torch.Tensor):
        values = values.contiguous()
        bases = [values.data_ptr() + 4 * S * P * b for b in range(B)]
    else:
        values = [c.contiguous() for c in values]
        bases = [c.data_ptr() for c in values]
    idx = idx.contiguous()
    out = torch.empty((B, S, W), dtype=dtype, device=device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    ptrs = (ctypes.c_void_p * B)(*bases)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.otto_gather_rows(ptrs, B, idx.data_ptr(), out.data_ptr(), S, P, W, stream)
    _build.check(err, "gather_rows")
    LAUNCHES.add()   # the pipelined runners launch from two threads
    return out

