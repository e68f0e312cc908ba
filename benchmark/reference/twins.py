"""Frozen copies of the plain PyTorch twins of kernels K1 and K2, from
`otto_tpu_torch/ops/kernels/gather.py` (`gather_rows_ref`, `MAX_COLS`) and
`otto_tpu_torch/ops/kernels/segscan.py` (`identity`, `_combine`,
`segmented_scan_ref`) at commit 7f160d3. The reference's groupbys run on
these, on whatever device holds their inputs.
"""
from __future__ import annotations

import torch

# column pointers one K1 launch takes; the transport sort splits its
# columns into groups of at most this many, as the port does
MAX_COLS = 256
I32_MAX = 2**31 - 1


def gather_rows_ref(values, idx: torch.Tensor) -> torch.Tensor:
    """Plain twin: `torch.gather` on the stack (a column list is stacked)."""
    if not isinstance(values, torch.Tensor):
        values = torch.stack(list(values))
    B = values.shape[0]
    ix = idx.long().unsqueeze(0).expand(B, -1, -1)
    return torch.gather(values, 2, ix)


def identity(dtype: torch.dtype, red: str):
    """The reducer's identity: 0; +-(2^31 - 1) for int32 min/max; the f32
    finfo bounds for float32 min/max."""
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


def segmented_scan_ref(values: torch.Tensor, first: torch.Tensor, red: str) -> torch.Tensor:
    """Plain twin: a Hillis-Steele network with slices for the shifts.
    Element i stops absorbing earlier elements once its window reaches its
    segment start (`blocked`); the shifted-in lanes carry the identity."""
    a = values
    P = a.shape[-1]
    blocked = first.expand(a.shape)
    ident = identity(a.dtype, red)
    d = 1
    while d < P:
        a_sh = torch.cat([torch.full_like(a[..., :d], ident), a[..., :-d]], dim=-1)
        b_sh = torch.cat([torch.ones_like(blocked[..., :d]), blocked[..., :-d]], dim=-1)
        a = torch.where(blocked, a, _combine(red, a, a_sh))
        blocked = blocked | b_sh
        d *= 2
    return a
