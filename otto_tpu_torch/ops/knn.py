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

With a mesh, query rows split over the data ranks and every rank searches
the whole corpus (replicated) with K3 (otto_tpu's make_sharded_topk); the
results come back to every rank by all_gather.
"""
from __future__ import annotations

from typing import Tuple

import torch

from otto_tpu_torch.ops.kernels.mips import mips_topk
from otto_tpu_torch.parallel.mesh import pad_to_multiple


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-9)


def knn_search(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "l2",
    query_block: int = 16384,
    mesh_ctx=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [Q, D], corpus [V, D] float32 on one device ->
    (scores [Q, k] float32, index [Q, k] int32), sorted by score
    descending; index -1 (score -3.4e38) where V < k.

    With `mesh_ctx` (every data rank calling with the same queries and
    corpus), query_block rounds up to a multiple of n_data, a short last
    block is padded with zero rows, each rank searches its equal share of
    every block (make_sharded_topk) and every rank returns all rows."""
    if metric == "cos":
        queries, corpus, metric = _unit_rows(queries), _unit_rows(corpus), "dot"
    Q = queries.shape[0]
    search = lambda q: mips_topk(q, corpus, k, metric)   # noqa: E731
    if mesh_ctx is not None and mesh_ctx.n_data > 1:
        query_block = pad_to_multiple(query_block, mesh_ctx.n_data)
        search = make_sharded_topk(mesh_ctx, corpus, k, metric)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=queries.device)
    for i in range(0, Q, query_block):
        qb = queries[i:i + query_block]
        nb = qb.shape[0]
        if nb < query_block and mesh_ctx is not None and mesh_ctx.n_data > 1:
            qb = torch.cat([qb, qb.new_zeros((query_block - nb, qb.shape[1]))])
        s, ix = search(qb)
        out_s[i:i + nb] = s[:nb]
        out_i[i:i + nb] = ix[:nb]
    return out_s, out_i


def make_sharded_topk(mesh_ctx, corpus: torch.Tensor, k: int, metric: str = "l2"):
    """-> search(q [B, D]) -> (scores, index) [B, k] on every data rank, B a
    multiple of n_data: each rank runs K3 on its B / n rows against the
    whole corpus, and the results are all_gathered in rank order."""
    def search(q):
        s, ix = mips_topk(q[mesh_ctx.data_slice(q.shape[0])], corpus, k, metric)
        return mesh_ctx.gather_data(s), mesh_ctx.gather_data(ix)

    return search
