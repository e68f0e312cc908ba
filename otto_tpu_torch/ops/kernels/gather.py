"""K1: batched row-wise gather `out[b, s, w] = values[b, s, idx[s, w]]`.

B stacked columns of one 4-byte dtype share one row-local index map; the
index width W may differ from the row width P (the GBDT tree walk gathers
T = 150 tree-bin columns from F = 104 feature columns). The CUDA kernel is
`otto_tpu_torch/csrc/gather_rows.cu`; `gather_rows_ref` is its plain
PyTorch twin. A CPU tensor goes to the twin, a CUDA tensor to the kernel.
"""
from __future__ import annotations

import torch

from otto_tpu_torch.ops.kernels import _build

# kernel launches since the last reset (a plain counter: chip_smoke.py
# zeroes it before the main path and reads it after)
launches = 0

_DTYPES = (torch.int32, torch.float32)


def gather_rows_ref(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain twin: `torch.gather` on the stack."""
    B = values.shape[0]
    ix = idx.long().unsqueeze(0).expand(B, -1, -1)
    return torch.gather(values, 2, ix)


def gather_rows(
    values: torch.Tensor, idx: torch.Tensor, check: bool = False
) -> torch.Tensor:
    """values [B, S, P] int32 | float32, idx [S, W] int32 in [0, P) ->
    [B, S, W]. `check=True` verifies the index range first (one device
    sync; the kernel itself does not bound-check)."""
    if values.dim() != 3 or idx.dim() != 2 or idx.shape[0] != values.shape[1]:
        raise ValueError(
            f"gather_rows: values {tuple(values.shape)} / idx "
            f"{tuple(idx.shape)} are not [B, S, P] / [S, W]"
        )
    if values.dtype not in _DTYPES or idx.dtype != torch.int32:
        raise TypeError(
            f"gather_rows: values {values.dtype} (int32|float32), "
            f"idx {idx.dtype} (int32)"
        )
    if values.device != idx.device:
        raise ValueError("gather_rows: values and idx on different devices")
    B, S, P = values.shape
    W = idx.shape[1]
    if check and idx.numel() and (
        int(idx.min()) < 0 or int(idx.max()) >= P
    ):
        raise IndexError(f"gather_rows: index outside [0, {P})")
    if values.device.type == "cpu":
        return gather_rows_ref(values, idx)
    if values.device.type != "cuda":
        raise ValueError(f"gather_rows: no kernel for {values.device}")
    values = values.contiguous()
    idx = idx.contiguous()
    out = torch.empty((B, S, W), dtype=values.dtype, device=values.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.otto_gather_rows(
            values.data_ptr(), idx.data_ptr(), out.data_ptr(),
            B, S, P, W, stream,
        )
    _build.check(err, "gather_rows")
    global launches
    with _build.count_lock:   # the pipelined runners launch from two threads
        launches += 1
    return out
