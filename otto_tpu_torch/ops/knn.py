"""Exact top-k nearest neighbours (C9).

Counterpart of otto_tpu/ops/knn.py::knn_search: the host driver streams
query blocks through K3 (`ops/kernels/mips.py`) against the whole corpus.
The tensors' device decides where it runs: the CUDA kernel on the card,
its plain twin on the CPU.

Metrics: 'l2' (negated squared L2 distance, larger = closer) and 'dot'
go to the kernel as they are; 'cos' normalises queries and corpus rows
first (norms clamped at 1e-9, as otto_tpu's CPU path does) and then takes
'dot'. On an exact tie the lower corpus index comes first, as on otto_tpu's
CPU path.
"""
from __future__ import annotations

from typing import Tuple

import torch

from otto_tpu_torch.ops.kernels.mips import mips_topk


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-9)


def knn_search(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "l2",
    query_block: int = 16384,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [Q, D], corpus [V, D] float32 on one device ->
    (scores [Q, k] float32, index [Q, k] int32), sorted by score
    descending; index -1 (score -3.4e38) where V < k."""
    if metric == "cos":
        queries, corpus, metric = _unit_rows(queries), _unit_rows(corpus), "dot"
    Q = queries.shape[0]
    out_s = torch.empty((Q, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=queries.device)
    for i in range(0, Q, query_block):
        s, ix = mips_topk(queries[i:i + query_block], corpus, k, metric)
        out_s[i:i + query_block] = s
        out_i[i:i + query_block] = ix
    return out_s, out_i
