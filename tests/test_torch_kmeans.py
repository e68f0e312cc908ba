"""k-means against otto_tpu.

`assign` and `lloyd_step` run on the same points and centroids. The fit
runs from the same start: otto_tpu's k-means++ draws come from jax's
threefry, the port's from a torch.Generator, so the test puts otto_tpu's
`_kmeanspp_init_device` centroids in place of the port's `init_centroids`.

Tolerances: centroids within 1e-5 relative + 1e-5 absolute; inertia
within 1e-5 relative; a distance within 1e-6 of |x|^2 + |c|^2 (the terms
it cancels, ~300 here, so a point's distance to itself may come out as a
few 1e-5 on either side). Both sides compute |x|^2 + |c|^2 - 2 x.c and
the per-cluster sums with float32 products summed in other orders
(torch's matmul vs XLA's dot). Labels are equal: the points are
blobs with no point near a boundary between two centroids, except the
constructed tie, where both take the first centroid.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.ops import kmeans as ref_kmeans
from otto_tpu_torch.ops import kmeans
import torch_threads  # noqa: F401

TOL = 1e-5


def blobs(seed, k=6, per=80, d=8, scale=0.6):
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=6.0, size=(k, d))
    x = np.concatenate([c + rng.normal(scale=scale, size=(per, d)) for c in centres])
    return x[rng.permutation(len(x))].astype(np.float32)


def test_assign_matches_reference():
    x = blobs(0)
    c = x[:10].copy()
    c[3] = c[7]      # duplicate centroids: the first of the two wins
    want_l, want_d = ref_kmeans.assign(jnp.asarray(x), jnp.asarray(c))
    got_l, got_d = kmeans.assign(torch.from_numpy(x), torch.from_numpy(c))
    assert got_l.dtype == torch.int32
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    assert not (got_l == 7).any() and (got_l == 3).any()
    terms = (x * x).sum(1).max() + (c * c).sum(1).max()
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=TOL,
                               atol=1e-6 * terms)


def test_lloyd_step_matches_reference():
    x = blobs(1)
    c = x[:6].copy() + 0.5
    c[5] = 1e3       # an empty cluster keeps its centroid
    want = ref_kmeans.lloyd_step(jnp.asarray(x), jnp.asarray(c))
    got = kmeans.lloyd_step(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=TOL, atol=TOL)
    assert torch.equal(got[0][5], torch.from_numpy(c[5]))
    for g, w in zip(got[1:], want[1:]):
        assert g.dim() == 0
        np.testing.assert_allclose(float(g), float(w), rtol=TOL)


def _ref_init(x, k, seed, init_sample):
    """The centroids otto_tpu's kmeans_fit starts from (its _fit_core)."""
    kseed, kinit = jax.random.split(jax.random.PRNGKey(seed))
    xd = jnp.asarray(x)
    if init_sample < x.shape[0]:
        xd = xd[jax.random.choice(kseed, x.shape[0], (init_sample,), replace=False)]
    return np.array(ref_kmeans._kmeanspp_init_device(xd, k, kinit))


@pytest.mark.parametrize("k,seed,init_sample,max_iter", [
    (6, 42, 1 << 16, 100),
    (9, 3, 200, 100),     # seeding on a subsample
    (6, 5, 1 << 16, 2),   # stopped by max_iter
])
def test_kmeans_fit_from_reference_init(monkeypatch, k, seed, init_sample, max_iter):
    x = blobs(2)
    init = _ref_init(x, k, seed, init_sample)
    want_c, want_l, want_in, want_it = ref_kmeans.kmeans_fit(
        x, k, max_iter=max_iter, seed=seed, init_sample=init_sample)

    def reference_init(xt, n, sample, generator):
        assert (n, sample) == (k, init_sample)
        return torch.from_numpy(init).to(xt.device)

    monkeypatch.setattr(kmeans, "init_centroids", reference_init)
    got_c, got_l, got_in, got_it = kmeans.kmeans_fit(
        torch.from_numpy(x), k, max_iter=max_iter, seed=seed, init_sample=init_sample)
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    assert got_it == want_it and (max_iter > 2 or got_it == 2)
    np.testing.assert_allclose(got_in, want_in, rtol=TOL)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=TOL, atol=TOL)


def test_torch_init_separates_blobs():
    """As tests/test_knn_kmeans.py::test_kmeans_separates_blobs, with the
    port's own k-means++ seeding."""
    rng = np.random.default_rng(0)
    centers = np.array([[0, 0], [10, 10], [-10, 10]], np.float32)
    x = np.concatenate(
        [c + rng.normal(scale=0.5, size=(100, 2)) for c in centers]).astype(np.float32)
    cents, labels, inertia, n_iter = kmeans.kmeans_fit(
        torch.from_numpy(x), 3, max_iter=50, seed=1)
    labels = labels.numpy()
    for b in range(3):
        assert len(np.unique(labels[b * 100:(b + 1) * 100])) == 1
    assert len(np.unique(labels)) == 3
    assert inertia < 3 * 100 * 2 * 1.0
    assert n_iter < 50


def test_torch_init_is_seeded_kmeanspp():
    x = torch.from_numpy(blobs(4))
    a = kmeans.init_centroids(x, 6, 1 << 16, torch.Generator().manual_seed(7))
    b = kmeans.init_centroids(x, 6, 1 << 16, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    # every centre is one of the points; k-means++ spreads them over the
    # blobs (each blob's points lie far from the others')
    assert all(bool((x == c).all(dim=1).any()) for c in a)
    labels, _ = kmeans.assign(x, a)
    assert len(torch.unique(labels)) == 6
    sub = kmeans.init_centroids(x, 6, 100, torch.Generator().manual_seed(7))
    assert sub.shape == (6, 8)
    same = x[:1].repeat(5, 1)           # all distances 0: uniform draws
    assert torch.equal(kmeans.init_centroids(same, 3, 64, torch.Generator()),
                       same[:3])
