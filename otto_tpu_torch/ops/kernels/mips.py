"""K3: exact top-k similarity search, `[Q, D] x [V, D]` -> `[Q, k]`.

Scores are the inner product ('dot') or the negated squared L2 distance
('l2', as `2 * (q . c) - |q|^2 - |c|^2`). Results are sorted by score
descending and, on an exact tie, by corpus index ascending; when V < k the
missing entries are index -1 with score -3.4e38. The CUDA kernel is
`otto_tpu_torch/csrc/mips_topk.cu`; `mips_topk_ref` is its plain PyTorch
twin. A CPU tensor goes to the twin, a CUDA tensor to the kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

from otto_tpu_torch.ops.kernels import _build

# kernel launches since the last reset (see gather.launches)
launches = 0

NEG_INF = -3.4e38     # score of a missing entry (V < k)
MAX_K = 32            # the kernel keeps a warp's top-k one entry per lane
MAX_D = 290           # two [D, ~130] float32 tiles in 227 KB of shared memory
METRICS = ("l2", "dot")


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 per row, float32 [N]: the norms both the kernel and the twin
    subtract (computed once, here, so that they agree bit for bit)."""
    return (x * x).sum(dim=1)


def _check(queries, corpus, k, metric):
    if queries.dim() != 2 or corpus.dim() != 2 or queries.shape[1] != corpus.shape[1]:
        raise ValueError(
            f"mips_topk: queries {tuple(queries.shape)} / corpus "
            f"{tuple(corpus.shape)} are not [Q, D] / [V, D]"
        )
    if queries.dtype != torch.float32 or corpus.dtype != torch.float32:
        raise TypeError(f"mips_topk: float32 only, got {queries.dtype} / {corpus.dtype}")
    if queries.device != corpus.device:
        raise ValueError("mips_topk: queries and corpus on different devices")
    if metric not in METRICS:
        raise ValueError(f"mips_topk: metric {metric!r} not in {METRICS}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"mips_topk: k = {k} outside [1, {MAX_K}]")
    if queries.shape[1] > MAX_D:
        raise ValueError(f"mips_topk: D = {queries.shape[1]} > {MAX_D}")
    if max(queries.shape[0], corpus.shape[0]) >= 2**31:
        raise ValueError("mips_topk: Q and V must stay below 2^31")


def mips_topk_ref(
    queries: torch.Tensor, corpus: torch.Tensor, k: int, metric: str = "l2",
    tile: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin: corpus tiles scored by `torch.matmul`, merged into the
    running top-k by a stable descending sort of [best ++ tile] (so an
    earlier, lower index wins a tie)."""
    _check(queries, corpus, k, metric)
    Q, V = queries.shape[0], corpus.shape[0]
    dev = queries.device
    best_s = torch.full((Q, k), float("-inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((Q, k), -1, dtype=torch.int32, device=dev)
    qsq = sq_norms(queries)[:, None] if metric == "l2" else None
    for v0 in range(0, V, tile):
        c = corpus[v0:v0 + tile]
        s = torch.matmul(queries, c.t())
        if metric == "l2":
            s = 2.0 * s - qsq - sq_norms(c)[None, :]
        ids = torch.arange(v0, v0 + c.shape[0], dtype=torch.int32, device=dev)
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, ids.expand(Q, -1)], dim=1)
        srt, pos = torch.sort(cat_s, dim=1, descending=True, stable=True)
        best_s = srt[:, :k]
        best_i = torch.gather(cat_i, 1, pos[:, :k])
    empty = best_i < 0
    return best_s.masked_fill(empty, NEG_INF), best_i


def mips_topk(
    queries: torch.Tensor, corpus: torch.Tensor, k: int, metric: str = "l2"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [Q, D], corpus [V, D] float32 on one device, 1 <= k <= 32,
    D <= 290 -> (scores [Q, k] float32, index [Q, k] int32)."""
    _check(queries, corpus, k, metric)
    if queries.device.type == "cpu":
        return mips_topk_ref(queries, corpus, k, metric)
    if queries.device.type != "cuda":
        raise ValueError(f"mips_topk: no kernel for {queries.device}")
    queries = queries.contiguous()
    corpus = corpus.contiguous()
    Q, D = queries.shape
    V = corpus.shape[0]
    l2 = metric == "l2"
    qsq = sq_norms(queries) if l2 else None
    csq = sq_norms(corpus) if l2 else None
    out_s = torch.empty((Q, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=queries.device)
    if Q == 0:
        return out_s, out_i
    lib = _build.load()
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.otto_mips_topk(
            queries.data_ptr(), corpus.data_ptr(),
            qsq.data_ptr() if l2 else None, csq.data_ptr() if l2 else None,
            out_s.data_ptr(), out_i.data_ptr(), Q, V, D, k, int(l2), stream,
        )
    _build.check(err, "mips_topk")
    global launches
    launches += 1
    return out_s, out_i
