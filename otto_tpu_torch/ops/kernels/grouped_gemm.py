"""K9: a grouped matrix product over expert segments (the MoE layers of
models/mla_moe.py).

Rows are sorted by expert: sorted row r belongs to expert e where
offsets[e] <= r < offsets[e + 1] (offsets [E + 1] int32, offsets[0] = 0,
offsets[E] = R, never falling). Sorted row r reads its A row
`a[rows[r]]` (rows [R] int32; None: `a[r]`). The weights are one
[E, N_w, K] bfloat16 tensor, each expert's rows its outputs (the layout of
a Linear's weight). The products take bfloat16 operands and sum in
float32. Two forms:

- gate_up=True (the experts' first product, N_w = 2 N: gate rows then up
  rows): out [R, N] bfloat16 (new, or the one given), out[r] = bf16(silu(g) * u) with g = A_r .
  W_e[:N]^T and u = A_r . W_e[N:]^T, SiLU and the product in float32;
- gate_up=False (the second): out [R_out, N] float32, out[out_rows[r]] =
  row_scale[r] * (A_r . W_e^T) (out_rows None: row r; row_scale None: 1);
  rows of `out` that no sorted row names are left as they are.

An expert may hold no rows, or every row. The CUDA kernel is
`otto_tpu_torch/csrc/grouped_gemm.cu` (one launch a call: every expert's
128-row tiles by every 128-column tile, `mma.sync` on the tensor cores,
A rows gathered as they are loaded, the epilogue fused);
`grouped_gemm_ref` is its plain twin, a per-expert loop of `torch.mm` on
the float32 values of the bfloat16 operands, which a CPU tensor runs. The
kernel sums in another order than the twin, so the two agree to float32
rounding (and, where that moves a bfloat16 output across a rounding, one
bfloat16 step), not bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from otto_tpu_torch.ops.kernels import _build
from otto_tpu_torch.utils import timing

# kernel launches since the last reset (see gather.LAUNCHES)
LAUNCHES = timing.counter("otto::kernels.grouped_gemm")

# rows and columns a block (grouped_gemm.cu BM, BN) and the depth of a step
# (BK): the kernel takes K a multiple of BK and N a multiple of BN (BN / 2
# for each half in gate_up form)
TILE_ROWS = 128
TILE_COLS = 128
TILE_K = 32
# grid.y's limit: the row tiles of one call
MAX_ROW_TILES = 65535


def _check(a, w, offsets, rows, gate_up, out_rows, row_scale, out):
    if not all(isinstance(t, torch.Tensor) for t in (a, w, offsets)):
        raise TypeError("grouped_gemm: a, w and offsets must be tensors")
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"grouped_gemm: a {a.dtype} and w {w.dtype} must be bfloat16")
    if offsets.dtype != torch.int32:
        raise TypeError(f"grouped_gemm: offsets {offsets.dtype}, want int32")
    if a.dim() != 2 or w.dim() != 3 or w.shape[2] != a.shape[1]:
        raise ValueError(f"grouped_gemm: a {tuple(a.shape)}, w {tuple(w.shape)} are not "
                         "[M, K], [E, N_w, K]")
    E, N_w, _ = w.shape
    if offsets.shape != (E + 1,):
        raise ValueError(f"grouped_gemm: offsets {tuple(offsets.shape)}, want [E + 1 = {E + 1}]")
    if gate_up and N_w % 2:
        raise ValueError(f"grouped_gemm: gate_up takes an even N_w, not {N_w}")
    R = a.shape[0]
    if rows is not None:
        if rows.dtype != torch.int32 or rows.dim() != 1:
            raise TypeError("grouped_gemm: rows must be [R] int32")
        R = rows.shape[0]
    if gate_up and (out_rows is not None or row_scale is not None):
        raise ValueError("grouped_gemm: gate_up writes its [R, N] output in sorted order")
    if gate_up and out is not None and (out.dtype != torch.bfloat16 or not out.is_contiguous()
                                        or tuple(out.shape) != (R, N_w // 2)):
        raise ValueError(f"grouped_gemm: gate_up's out must be a contiguous [R = {R}, "
                         f"{N_w // 2}] bfloat16 tensor")
    if out_rows is not None and (out_rows.dtype != torch.int32 or out_rows.shape != (R,)):
        raise ValueError(f"grouped_gemm: out_rows must be [R = {R}] int32")
    if row_scale is not None and (row_scale.dtype != torch.float32 or row_scale.shape != (R,)):
        raise ValueError(f"grouped_gemm: row_scale must be [R = {R}] float32")
    if not gate_up and out is not None and (out.dtype != torch.float32 or out.dim() != 2
                                            or out.shape[1] != N_w or not out.is_contiguous()):
        raise ValueError(f"grouped_gemm: out must be a contiguous [R_out, {N_w}] float32 tensor")
    if out is None and out_rows is not None:
        raise ValueError("grouped_gemm: out_rows needs the out it indexes")
    ts = [t for t in (a, w, offsets, rows, out_rows, row_scale, out) if t is not None]
    if len({t.device for t in ts}) != 1:
        raise ValueError("grouped_gemm: tensors on more than one device: "
                         f"{sorted({str(t.device) for t in ts})}")
    return R


def check_segments(offsets: torch.Tensor, R: int) -> None:
    """The segments' contents (one sync on a card): offsets start at 0,
    never fall and end at R."""
    off = offsets.long()
    bad = torch.stack([off[0] != 0, off[-1] != R, (off[1:] < off[:-1]).any()]).cpu()
    names = ("offsets[0] != 0", f"offsets[-1] != R = {R}", "offsets fall")
    wrong = [n for n, b in zip(names, bad.tolist()) if b]
    if wrong:
        raise ValueError("grouped_gemm: bad segments: " + ", ".join(wrong))


def grouped_gemm_ref(a, w, offsets, rows=None, gate_up=False, out_rows=None,
                     row_scale=None, out=None) -> torch.Tensor:
    """Plain twin: one torch.mm an expert over its segment, in float32 on
    the bfloat16 values."""
    R = _check(a, w, offsets, rows, gate_up, out_rows, row_scale, out)
    check_segments(offsets, R)
    E, N_w, _ = w.shape
    N = N_w // 2 if gate_up else N_w
    ar = a if rows is None else a[rows.long()]
    y = torch.empty((R, N), dtype=torch.float32, device=a.device)
    bounds = offsets.tolist()
    for e in range(E):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            p = torch.mm(ar[lo:hi].float(), w[e].float().t())
            y[lo:hi] = F.silu(p[:, :N]) * p[:, N:] if gate_up else p
    if gate_up:
        return y.to(torch.bfloat16) if out is None else out.copy_(y)
    if row_scale is not None:
        y *= row_scale[:, None]
    if out is None:
        return y
    out[out_rows.long() if out_rows is not None else slice(0, R)] = y
    return out


def grouped_gemm(a, w, offsets, rows: Optional[torch.Tensor] = None, gate_up: bool = False,
                 out_rows: Optional[torch.Tensor] = None,
                 row_scale: Optional[torch.Tensor] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The module's doc says what; -> out. A CPU tensor runs the twin; a
    CUDA tensor one launch of the kernel on the current stream (K a
    multiple of TILE_K, N of TILE_COLS, or of TILE_COLS / 2 in gate_up
    form; A, W and the output 16-byte aligned). The kernel trusts the
    segments' contents: check_segments validates them (a sync)."""
    R = _check(a, w, offsets, rows, gate_up, out_rows, row_scale, out)
    if a.device.type == "cpu":
        return grouped_gemm_ref(a, w, offsets, rows, gate_up, out_rows, row_scale, out)
    if a.device.type != "cuda":
        raise ValueError(f"grouped_gemm: no kernel for {a.device}")
    E, N_w, K = w.shape
    N = N_w // 2 if gate_up else N_w
    step = TILE_COLS // 2 if gate_up else TILE_COLS
    if K % TILE_K or N % step:
        raise ValueError(f"grouped_gemm: the kernel takes K a multiple of {TILE_K} and N of "
                         f"{step}, not K {K}, N {N}")
    a, w = a.contiguous(), w.contiguous()
    if any(t.data_ptr() % 16 for t in (a, w)):
        raise ValueError("grouped_gemm: a and w must start 16-byte aligned")
    if out is None:
        out = torch.empty((R, N), dtype=torch.bfloat16 if gate_up else torch.float32,
                          device=a.device)
    if R == 0 or E == 0:
        return out
    if out.data_ptr() % 16:
        raise ValueError("grouped_gemm: out must start 16-byte aligned")
    cnt = offsets[1:] - offsets[:-1]
    tile_off = torch.zeros(E + 1, dtype=torch.int32, device=a.device)
    tile_off[1:] = torch.cumsum((cnt + TILE_ROWS - 1) // TILE_ROWS, 0, dtype=torch.int32)
    # an upper bound of the row tiles, known without a sync: the blocks past
    # the last tile return at once
    row_tiles = (R + E * (TILE_ROWS - 1)) // TILE_ROWS
    if row_tiles > MAX_ROW_TILES:
        raise ValueError(f"grouped_gemm: {R} rows over {E} experts need up to {row_tiles} "
                         f"row tiles, the grid holds {MAX_ROW_TILES}")
    lib = _build.load()

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.otto_grouped_gemm(
            a.data_ptr(), w.data_ptr(), out.data_ptr(), offsets.data_ptr(), tile_off.data_ptr(),
            ptr(rows), ptr(out_rows), ptr(row_scale), E, N, K, int(gate_up), row_tiles,
            N // step, stream)
    _build.check(err, "grouped_gemm")
    LAUNCHES.add()   # the pipelined runners launch from two threads
    return out
