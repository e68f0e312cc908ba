"""KMeans: k-means++ seeding and Lloyd's iterations (C11).

Counterpart of otto_tpu/ops/kmeans.py (`assign`, `lloyd_step`, the
k-means++ init, `kmeans_fit`), on the points' device:

  * distances are |x|^2 + |c|^2 - 2 x.c, with the product by
    `torch.matmul` (TF32 off: `device.pin_fp32`); the label is the first
    nearest centroid on a tie, as `jnp.argmin` gives;
  * a centroid is the mean of its points, summed as one-hot x points
    products in blocks of rows (deterministic, unlike atomic adds); an
    empty cluster keeps its centroid;
  * the fit stops, as sklearn's does, when the squared Frobenius norm of
    the centroid shift is at most tol x the mean per-feature variance, or
    after max_iter iterations;
  * k-means++ seeds on a random subsample of at most 64k points, drawn
    from a `torch.Generator` seeded with `seed`. Its draws differ from
    otto_tpu's (jax's threefry), so `init_centroids` is its own function,
    and a test can put otto_tpu's centroids in its place.
"""
from __future__ import annotations

from typing import Tuple

import torch

ROW_BLOCK = 1 << 20   # rows per block of the [N, K] distance and one-hot grids


def assign(
    x: torch.Tensor, centroids: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (labels [N] int32, squared distance to the chosen centroid [N],
    clamped at 0)."""
    K = centroids.shape[0]
    c_sq = (centroids * centroids).sum(dim=1)[None, :]
    ks = torch.arange(K, dtype=torch.int32, device=x.device)
    labels, best = [], []
    for i in range(0, x.shape[0], ROW_BLOCK):
        xb = x[i:i + ROW_BLOCK]
        x_sq = (xb * xb).sum(dim=1, keepdim=True)
        d = x_sq + c_sq - 2.0 * torch.matmul(xb, centroids.t())
        m = d.min(dim=1).values
        # first index among the minima
        labels.append(torch.where(d == m[:, None], ks, K).amin(dim=1).to(torch.int32))
        best.append(m.clamp(min=0.0))
    return torch.cat(labels), torch.cat(best)


def lloyd_step(
    x: torch.Tensor, centroids: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd iteration -> (new centroids, inertia of the assignment it
    made, squared Frobenius norm of the shift); the last two are 0-d
    tensors."""
    K, D = centroids.shape
    labels, dists = assign(x, centroids)
    ks = torch.arange(K, dtype=torch.int32, device=x.device)
    sums = torch.zeros((K, D), dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], ROW_BLOCK):
        onehot = (labels[i:i + ROW_BLOCK, None] == ks[None, :]).to(torch.float32)
        sums += torch.matmul(onehot.t(), x[i:i + ROW_BLOCK])
    cnts = torch.bincount(labels, minlength=K).to(torch.float32)[:, None]
    new = torch.where(cnts > 0, sums / cnts.clamp(min=1.0), centroids)
    return new, dists.sum(), ((new - centroids) ** 2).sum()


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
    tol: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor, float, int]:
    """Lloyd's iterations from `centroids` until the tol rule stops them
    -> (centroids, labels [N] int32, inertia of the last iteration, number
    of iterations)."""
    tol_thresh = float(tol * x.var(dim=0, unbiased=False).mean())
    inertia, shift, n_iter = float("inf"), float("inf"), 0
    while n_iter < max_iter and shift > tol_thresh:
        centroids, inertia_t, shift_t = lloyd_step(x, centroids)
        inertia, shift = float(inertia_t), float(shift_t)
        n_iter += 1
    labels, _ = assign(x, centroids)
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
