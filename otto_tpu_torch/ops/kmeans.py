"""KMeans: k-means++ seeding and Lloyd's iterations (C11).

Counterpart of otto_tpu/ops/kmeans.py (`assign`, `lloyd_step`, the
k-means++ init, `kmeans_fit`), on the points' device:

  * distances are |x|^2 + |c|^2 - 2 x.c, with the product by
    `torch.matmul` (TF32 off: `device.pin_fp32`) over blocks of
    `row_block(N)` points, N the points of the whole fit, the last block
    padded: every product has one shape, so a point's distances do not
    depend on which points share its block, nor on how the fit's points
    are split over ranks; the label is the first nearest centroid on a
    tie, as `jnp.argmin` gives;
  * a centroid is the mean of its points, summed in int64 fixed point (one
    power-of-two scale for all coordinates, room for every point) and
    rounded once: the sums do not depend on the order of the adds, nor on
    how the points are split; an empty cluster keeps its centroid;
  * the fit stops, as sklearn's does, when the squared Frobenius norm of
    the centroid shift is at most tol x the mean per-feature variance, or
    after max_iter iterations;
  * k-means++ seeds on a random subsample of at most 64k points, drawn
    from a `torch.Generator` seeded with `seed`. Its draws differ from
    otto_tpu's (jax's threefry), so `init_centroids` is its own function,
    and a test can put otto_tpu's centroids in its place.

`kmeans_fit_dp` is otto_tpu's data-parallel fit over a mesh's data ranks:
each rank holds a contiguous share of the points, and the fixed-point
scale, the per-cluster sums and counts and the inertia are all-reduced,
so every rank steps through the same centroids, those of one device from
the same start. Every rank seeds as kmeans_fit does, from all the points
and a generator seeded with `seed` (otto_tpu draws its k-means++
subsample per shard), so on any number of ranks the fit is kmeans_fit's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

ROW_BLOCK = 1 << 16   # most points a block of the [N, K] distance grid holds
# replicas of every cluster's sum on the card (point n adds into replica
# n % SUM_REPLICAS), so that the few hot cells do not serialise the adds
SUM_REPLICAS = 32


def row_block(n_points: int) -> int:
    """Points a distance block holds for a fit over n_points points (every
    rank's together): ROW_BLOCK, or the power of two that holds them all."""
    return min(ROW_BLOCK, 1 << max(0, n_points - 1).bit_length())


def assign(
    x: torch.Tensor, centroids: torch.Tensor, block: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (labels [N] int32, squared distance to the chosen centroid [N],
    clamped at 0), in blocks of `block` points (default row_block(N))."""
    K = centroids.shape[0]
    block = block or row_block(x.shape[0])
    c_sq = (centroids * centroids).sum(dim=1)[None, :]
    ks = torch.arange(K, dtype=torch.int32, device=x.device)
    labels, best = [], []
    for i in range(0, x.shape[0], block):
        xb = x[i:i + block]
        n = xb.shape[0]
        if n < block:
            xb = torch.cat([xb, xb.new_zeros((block - n, xb.shape[1]))])
        x_sq = (xb * xb).sum(dim=1, keepdim=True)
        d = (x_sq + c_sq - 2.0 * torch.matmul(xb, centroids.t()))[:n]
        m = d.min(dim=1).values
        # first index among the minima
        labels.append(torch.where(d == m[:, None], ks, K).amin(dim=1).to(torch.int32))
        best.append(m.clamp(min=0.0))
    if not labels:
        return (torch.zeros(0, dtype=torch.int32, device=x.device),
                torch.zeros(0, device=x.device))
    return torch.cat(labels), torch.cat(best)


def _cluster_sums(x: torch.Tensor, labels: torch.Tensor, K: int, mesh_ctx=None):
    """Per-cluster sums of x's rows [K, D] float64 and counts [K] int64, in
    int64 fixed point: x scaled by one power of two so that the largest
    |x| takes 62 - bit_length(N) bits (N and the largest of every rank's
    points with `mesh_ctx`, whose sums are all-reduced)."""
    dev = x.device
    n = torch.tensor(x.shape[0], device=dev)
    amax = x.abs().amax() if x.shape[0] else x.new_zeros(())
    if mesh_ctx is not None:
        mesh_ctx.all_sum(n)
        mesh_ctx.all_max(amax)
    _, e = torch.frexp(amax)
    s = (62 - max(1, int(n)).bit_length() - e).clamp(-126, 126)
    q = torch.round(torch.ldexp(x, s)).to(torch.int64)
    reps = SUM_REPLICAS if dev.type == "cuda" else 1
    cell = labels.long() * reps + torch.arange(x.shape[0], device=dev) % reps
    sums = torch.zeros((K * reps, x.shape[1]), dtype=torch.int64, device=dev)
    sums.index_add_(0, cell, q)
    sums = sums.view(K, reps, -1).sum(1)
    cnts = torch.bincount(labels.long(), minlength=K)
    if mesh_ctx is not None:
        mesh_ctx.all_sum(sums)
        mesh_ctx.all_sum(cnts)
    return torch.ldexp(sums.to(torch.float64), (-s).to(torch.float64)), cnts


def lloyd_step(
    x: torch.Tensor, centroids: torch.Tensor, mesh_ctx=None, block: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd iteration -> (new centroids, inertia of the assignment it
    made, squared Frobenius norm of the shift); the last two are 0-d
    tensors. With `mesh_ctx`, x is this data rank's share of the points
    and the sums, counts and inertia are all-reduced over the data ranks
    (`block`: assign's, from the points of every rank)."""
    K = centroids.shape[0]
    labels, dists = assign(x, centroids, block)
    sums, cnts = _cluster_sums(x, labels, K, mesh_ctx)
    inertia = dists.to(torch.float64).sum()
    if mesh_ctx is not None:
        mesh_ctx.all_sum(inertia)
    cnts = cnts[:, None]
    new = torch.where(cnts > 0, (sums / cnts.clamp(min=1)).to(torch.float32), centroids)
    return new, inertia.to(torch.float32), ((new - centroids) ** 2).sum()


def init_centroids(
    x: torch.Tensor, k: int, init_sample: int, generator: torch.Generator
) -> torch.Tensor:
    """k-means++ on a subsample of `init_sample` points (all of them when
    there are fewer): a first centre drawn uniformly, each next one with
    probability proportional to its squared distance from the chosen set
    (uniformly when every distance is 0). -> [k, D]."""
    dev = x.device
    n = x.shape[0]
    if init_sample and init_sample < n:
        pick = torch.randperm(n, generator=generator, device=dev)[:init_sample]
        x = x[pick]
        n = init_sample
    first = torch.randint(0, n, (1,), generator=generator, device=dev)
    centres = [x[first]]
    d2 = ((x - centres[0]) ** 2).sum(dim=1)
    for _ in range(1, k):
        p = torch.where(d2.sum() > 0, d2, torch.ones_like(d2))
        c = x[torch.multinomial(p, 1, generator=generator)]
        centres.append(c)
        d2 = torch.minimum(d2, ((x - c) ** 2).sum(dim=1))
    return torch.cat(centres)


def lloyd_fit(
    x: torch.Tensor, centroids: torch.Tensor, max_iter: int = 100,
    tol: float = 1e-3, mesh_ctx=None, x_all: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, float, int]:
    """Lloyd's iterations from `centroids` until the tol rule stops them
    -> (centroids, labels [N] int32, inertia of the last iteration, number
    of iterations). With `mesh_ctx`, x is this data rank's share of the
    points `x_all` (which give the tol threshold) and the labels are those
    of this rank's points."""
    x_all = x if x_all is None else x_all
    tol_thresh = float(tol * x_all.var(dim=0, unbiased=False).mean())
    block = row_block(x_all.shape[0])
    inertia, shift, n_iter = float("inf"), float("inf"), 0
    while n_iter < max_iter and shift > tol_thresh:
        centroids, inertia_t, shift_t = lloyd_step(x, centroids, mesh_ctx, block)
        inertia, shift = float(inertia_t), float(shift_t)
        n_iter += 1
    labels, _ = assign(x, centroids, block)
    return centroids, labels, inertia, n_iter


def kmeans_fit(
    x: torch.Tensor,
    n_clusters: int,
    max_iter: int = 100,
    tol: float = 1e-3,
    seed: int = 42,
    init_sample: int = 1 << 16,
) -> Tuple[torch.Tensor, torch.Tensor, float, int]:
    """Fit KMeans on x [N, D] float32 -> (centroids [K, D], labels [N]
    int32, inertia, n_iter), on x's device."""
    x = x.to(torch.float32)
    g = torch.Generator(device=x.device).manual_seed(seed)
    centroids = init_centroids(x, n_clusters, init_sample, g)
    return lloyd_fit(x, centroids, max_iter, tol)


def kmeans_fit_dp(
    x: torch.Tensor,
    n_clusters: int,
    mesh_ctx,
    max_iter: int = 100,
    tol: float = 1e-3,
    seed: int = 42,
    init_sample: int = 1 << 16,
    init: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, float, int]:
    """kmeans_fit over the data ranks: every rank passes all of x [N, D]
    and fits on its mesh_ctx.data_slice(N) of the rows, from kmeans_fit's
    k-means++ seeding (or `init` [K, D]). -> (centroids, labels [N] of
    every point, inertia, n_iter), the same on every rank: kmeans_fit's."""
    x = x.to(torch.float32)
    dev = x.device
    xs = x[mesh_ctx.data_slice(x.shape[0])]
    if init is None:
        init = init_centroids(x, n_clusters, init_sample,
                              torch.Generator(device=dev).manual_seed(seed))
    centroids, labels, inertia, n_iter = lloyd_fit(xs, init.to(dev), max_iter, tol, mesh_ctx,
                                                   x_all=x)
    return centroids, mesh_ctx.gather_varlen(labels), inertia, n_iter
