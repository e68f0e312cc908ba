"""K3: exact top-k similarity search, `[Q, D] x [V, D]` -> `[Q, k]`.

Scores are the inner product ('dot') or the negated squared L2 distance
('l2', as `2 * (q . c) - |q|^2 - |c|^2`). Results are sorted by score
descending and, on an exact tie, by corpus index ascending; when V < k the
missing entries are index -1 with score -3.4e38. The CUDA kernel is
`otto_tpu_torch/csrc/mips_topk.cu` (3xTF32 warpgroup MMAs on the tensor
cores, fed by a ring of bulk asynchronous copies of the corpus, split into
TF32 hi / lo parts once per call;
`split_plan` cuts the corpus into S ranges when the query blocks cannot
fill the card, and a second kernel merges the S partial lists);
`mips_topk_ref` is its plain PyTorch twin and `merge_partials_ref` the
merge's. A CPU tensor goes to the twin, a CUDA tensor to the kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from otto_tpu_torch.ops.kernels import _build

# calls that launched the kernel since the last reset (see gather.launches):
# one per call, which launches the corpus prep, the top-k kernel and, when
# it splits the corpus (or V = 0), the merge
launches = 0

NEG_INF = -3.4e38     # score of a missing entry (V < k)
MAX_K = 32            # a warp inserts into a top-k list one entry per lane
# the kernel holds each query's TF32 hi / lo fragments in registers and is
# compiled for up to 16 k8 steps
MAX_D = 128
METRICS = ("l2", "dot")
BLOCK_Q = 128         # queries per block of the kernel
TILE_V = 64           # corpus rows per tile of the kernel
MIN_SPLIT_TILES = 8   # a corpus split walks at least this many tiles


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


def split_plan(Q: int, V: int, n_sm: int) -> Tuple[int, int]:
    """(S, chunk): the kernel cuts the corpus into S contiguous ranges, S - 1
    of `chunk` rows (a multiple of TILE_V) and the last one running to V,
    when its ceil(Q / BLOCK_Q) query blocks cannot fill the n_sm SMs, so
    that blocks x S is about one wave. S = 1 when the query blocks fill a
    wave; every range walks at least MIN_SPLIT_TILES tiles."""
    tiles = -(-V // TILE_V)
    blocks = -(-Q // BLOCK_Q)
    s = min(n_sm // max(blocks, 1), tiles // MIN_SPLIT_TILES)
    if s <= 1:
        return 1, max(tiles, 1) * TILE_V
    per = -(-tiles // s)
    S = -(-tiles // per)
    if tiles - (S - 1) * per < MIN_SPLIT_TILES:
        S -= 1   # a short last range goes to the one before it
    return S, per * TILE_V


def split_bounds(V: int, S: int, chunk: int):
    """The corpus ranges [(v0, v1)] of the S splits, in index order."""
    return [(i * chunk, V if i == S - 1 else (i + 1) * chunk) for i in range(S)]


def merge_partials_ref(
    part_s: torch.Tensor, part_i: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the merge kernel: S sorted partial lists [S, Q, k]
    (index -1 where missing) -> the sorted top-k [Q, k], by a stable
    descending sort of the partials concatenated in split order (so that
    on a tie the earlier split, whose indices are lower, wins)."""
    S, Q = part_s.shape[:2]
    cat_s = part_s.permute(1, 0, 2).reshape(Q, -1)
    cat_i = part_i.permute(1, 0, 2).reshape(Q, -1)
    cat_s = cat_s.masked_fill(cat_i < 0, float("-inf"))
    pad = max(0, k - cat_s.shape[1])
    cat_s = F.pad(cat_s, (0, pad), value=float("-inf"))
    cat_i = F.pad(cat_i, (0, pad), value=-1)
    srt, pos = torch.sort(cat_s, dim=1, descending=True, stable=True)
    best_i = torch.gather(cat_i, 1, pos[:, :k])
    return srt[:, :k].masked_fill(best_i < 0, NEG_INF), best_i


def prep_words(D: int) -> int:
    """32-bit words of one corpus tile as the kernel reads it: TILE_V rows
    split into TF32 hi and lo parts, 8 words per row and k8 step each."""
    return 2 * TILE_V * 8 * -(-D // 8)


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
    D <= MAX_D -> (scores [Q, k] float32, index [Q, k] int32)."""
    _check(queries, corpus, k, metric)
    if queries.device.type == "cpu":
        return mips_topk_ref(queries, corpus, k, metric)
    if queries.device.type != "cuda":
        raise ValueError(f"mips_topk: no kernel for {queries.device}")
    queries = queries.contiguous()
    corpus = corpus.contiguous()
    Q = queries.shape[0]
    V = corpus.shape[0]
    dev = queries.device
    l2 = metric == "l2"
    qsq = sq_norms(queries) if l2 else None
    csq = sq_norms(corpus) if l2 else None
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    S, chunk = split_plan(Q, V, torch.cuda.get_device_properties(dev).multi_processor_count)
    tile_w = prep_words(queries.shape[1])
    # the corpus as the kernel reads it (written by its prep launch)
    cprep = torch.empty((-(-V // TILE_V), tile_w), dtype=torch.int32, device=dev)
    part_s = part_i = None
    if S > 1:
        part_s = torch.empty((S, Q, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((S, Q, k), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.otto_mips_topk(
            queries.data_ptr(), corpus.data_ptr(),
            qsq.data_ptr() if l2 else None, csq.data_ptr() if l2 else None,
            out_s.data_ptr(), out_i.data_ptr(), cprep.data_ptr(),
            part_s.data_ptr() if S > 1 else None,
            part_i.data_ptr() if S > 1 else None,
            Q, V, queries.shape[1], k, int(l2), S, chunk, tile_w, stream,
        )
    _build.check(err, "mips_topk")
    global launches
    launches += 1
    return out_s, out_i
