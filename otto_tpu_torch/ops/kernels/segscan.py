"""K2: inclusive segmented scan (sum | min | max) along the last axis.

values [B, S, P] int32 | float32 and segment-start flags first [S, P]
bool: after the scan the LAST lane of every segment holds the segment's
reduction, and nothing crosses a segment (int32 sums never see totals of
other segments). The CUDA kernel is `otto_tpu_torch/csrc/segscan.cu`;
`segmented_scan_ref` is its plain PyTorch twin. A CPU tensor goes to the
twin, a CUDA tensor to the kernel.
"""
from __future__ import annotations

import torch

from otto_tpu_torch.ops.kernels import _build
from otto_tpu_torch.utils import timing

# kernel launches since the last reset (see gather.LAUNCHES)
LAUNCHES = timing.counter("otto::kernels.segmented_scan")

_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}
_OP_CODE = {"sum": 0, "min": 1, "max": 2}

I32_MAX = 2**31 - 1


def identity(dtype: torch.dtype, red: str):
    """The reducer's identity: 0; +-(2^31 - 1) for int32 min/max; the f32
    finfo bounds for float32 min/max (otto_tpu.ops.segment._reduce_identity)."""
    if red == "sum":
        return 0
    if dtype.is_floating_point:
        fi = torch.finfo(dtype)
        return fi.max if red == "min" else fi.min
    return I32_MAX if red == "min" else -I32_MAX


def _combine(red: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if red == "sum":
        return a + b
    if red == "max":
        return torch.maximum(a, b)
    return torch.minimum(a, b)


def segmented_scan_ref(
    values: torch.Tensor, first: torch.Tensor, red: str
) -> torch.Tensor:
    """Plain twin: the Hillis-Steele network of
    otto_tpu.ops.segment.segmented_scan, with slices for the shifts.
    Element i stops absorbing earlier elements once its window reaches its
    segment start (`blocked`); the shifted-in lanes carry the identity."""
    a = values
    P = a.shape[-1]
    blocked = first.expand(a.shape)
    ident = identity(a.dtype, red)
    d = 1
    while d < P:
        a_sh = torch.cat(
            [torch.full_like(a[..., :d], ident), a[..., :-d]], dim=-1
        )
        b_sh = torch.cat(
            [torch.ones_like(blocked[..., :d]), blocked[..., :-d]], dim=-1
        )
        a = torch.where(blocked, a, _combine(red, a, a_sh))
        blocked = blocked | b_sh
        d *= 2
    return a


def segmented_scan(
    values: torch.Tensor, first: torch.Tensor, red: str
) -> torch.Tensor:
    """values [B, S, P] int32 | float32, first [S, P] bool, red in
    {'sum', 'min', 'max'} -> [B, S, P]."""
    if values.dim() != 3 or tuple(first.shape) != tuple(values.shape[1:]):
        raise ValueError(
            f"segmented_scan: values {tuple(values.shape)} / first "
            f"{tuple(first.shape)} are not [B, S, P] / [S, P]"
        )
    if values.dtype not in _DTYPE_CODE or first.dtype != torch.bool:
        raise TypeError(
            f"segmented_scan: values {values.dtype} (int32|float32), "
            f"first {first.dtype} (bool)"
        )
    if red not in _OP_CODE:
        raise ValueError(f"segmented_scan: reducer {red!r}")
    if values.device != first.device:
        raise ValueError("segmented_scan: values and first on different devices")
    if values.device.type == "cpu":
        return segmented_scan_ref(values, first, red)
    if values.device.type != "cuda":
        raise ValueError(f"segmented_scan: no kernel for {values.device}")
    values = values.contiguous()
    flags = first.contiguous().view(torch.uint8)
    out = torch.empty_like(values)
    if out.numel() == 0:
        return out
    B, S, P = values.shape
    lib = _build.load()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.otto_segscan(
            values.data_ptr(), flags.data_ptr(), out.data_ptr(),
            B, S, P, _DTYPE_CODE[values.dtype], _OP_CODE[red], stream,
        )
    _build.check(err, "segmented_scan")
    LAUNCHES.add()   # the pipelined runners launch from two threads
    return out
