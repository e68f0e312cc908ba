"""K5 (ops/kernels/gbdt_walk.py) on the CPU: the wrapper's checks, the
kernel's split decision against `_bin_program`, and the kernel's walk
(heap-ordered split nodes, the spare -inf column, leaves summed in
float64 in tree order) written out in PyTorch against the port's twin.
The kernel itself runs only on the card (tests/test_torch_cuda.py)."""
import math

import numpy as np
import pytest
import torch

from otto_tpu_torch.models import gbdt
from otto_tpu_torch.ops.kernels import gbdt_walk as k5
import torch_threads  # noqa: F401

F32 = torch.float32


def split_nodes(edges, gfeat, thr):
    """The kernel's split nodes (gbdt_walk.cu): (column, value) [T, D, W].
    thr <= B - 1 reads feature f against edges[f, thr - 1]; the no-op
    split thr == B reads the spare column F (-inf in every row) against
    +inf."""
    F, n_edges = edges.shape
    real = thr <= n_edges
    col = torch.where(real, gfeat.long(), F)
    if n_edges == 0:
        return col, torch.full(gfeat.shape, torch.inf)
    value = edges[gfeat.long(), (thr.long() - 1).clamp(0, n_edges - 1)]
    return col, torch.where(real, value, torch.inf)


def with_spare(x):
    """x [M, F] and the spare column F, -inf in every row."""
    return torch.cat([x, torch.full((x.shape[0], 1), -torch.inf)], dim=1)


def goes_right(xs, col, value):
    """The kernel's decision `!(value > x[col])`, x with its spare column."""
    return ~(value > xs[:, col])


def kernel_sum(val):
    """Leaf values [M, T] summed as the kernel sums them: float64 runs of
    consecutive trees (k5.leaf_sum_order), the runs added in order,
    rounded once."""
    acc = torch.zeros(val.shape[0], dtype=torch.float64)
    for a, b in k5.leaf_sum_order(val.shape[1]):
        run = torch.zeros(val.shape[0], dtype=torch.float64)
        for t in range(a, b):
            run += val[:, t].double()
        acc += run
    return acc.to(F32)


def walk_as_kernel(x, edges, gfeat, thr, leaf):
    """The kernel's walk in PyTorch: heap node h of each (row, tree),
    h -> 2h + 1 + right, leaves summed as the kernel sums them. ->
    (scores [M] f32, leaf values [M, T])."""
    T, D, W = gfeat.shape
    inner = 2 ** D - 1
    col, value = split_nodes(edges, gfeat, thr)
    level = [int(math.log2(j + 1)) for j in range(inner)]
    hcol = torch.stack([col[:, lv, j + 1 - 2 ** lv] for j, lv in enumerate(level)], 1)
    hval = torch.stack([value[:, lv, j + 1 - 2 ** lv] for j, lv in enumerate(level)], 1)
    xs = with_spare(x)
    h = torch.zeros((x.shape[0], T), dtype=torch.long)
    tree = torch.arange(T)[None, :]
    for _ in range(D):
        c, v = hcol[tree, h], hval[tree, h]
        right = ~(v > torch.gather(xs, 1, c))
        h = 2 * h + 1 + right.long()
    val = leaf[tree, h - inner]
    return kernel_sum(val), val


def edge_case_edges():
    """[5, 9] ascending edges: duplicates, -0.0 beside 0.0, +inf padding
    (collapsed quantiles), a -inf edge, denormals and wide values."""
    inf, tiny = math.inf, 1e-45
    return torch.tensor([
        [-2.0, -1.0, -0.0, 0.0, 0.0, 1.5, 3.0, inf, inf],
        [-math.inf, -5.0, -tiny, tiny, 2.0, 2.0, 2.0, 7.0, 1e30],
        [0.5, inf, inf, inf, inf, inf, inf, inf, inf],
        [-3e38, -1.0, -1e-30, 0.0, 1e-30, 1.0, 10.0, 100.0, 3e38],
        [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0],
    ], dtype=F32)


def edge_case_values(edges):
    """Every feature's edge cases: NaN, +-inf, +-0.0, each edge exactly and
    its float32 neighbours, beyond the last finite edge, denormals."""
    vals = [math.nan, -math.nan, math.inf, -math.inf, 0.0, -0.0, 1e-45, -1e-45,
            3.4e38, -3.4e38, 1e31, 11.0]
    e = edges[torch.isfinite(edges)]
    near = torch.cat([e, torch.nextafter(e, torch.full_like(e, math.inf)),
                      torch.nextafter(e, torch.full_like(e, -math.inf))])
    v = torch.cat([torch.tensor(vals, dtype=F32), near])
    return v[:, None].expand(-1, edges.shape[0]).contiguous()


def test_split_decision_equals_bins_at_edge_cases():
    """`!(edges[f, thr - 1] > x)` with the no-op split on the spare column
    equals `_bin_program(x) >= thr` for every feature, every thr in
    [1, B] and every edge case of x, NaN and +-inf included."""
    edges = edge_case_edges()
    x = edge_case_values(edges)
    n_bins = edges.shape[1] + 1
    bins = gbdt._bin_program(x, edges)
    F = edges.shape[0]
    f = torch.arange(F).repeat_interleave(n_bins)
    t = torch.arange(1, n_bins + 1).repeat(F)
    col, value = split_nodes(edges, f.to(torch.int32), t.to(torch.int32))
    got = goes_right(with_spare(x), col, value)
    want = bins[:, f] >= t
    assert got.shape == (x.shape[0], F * n_bins)
    assert torch.equal(got, want)
    # NaN and +inf bin past every edge, -inf before every edge above -inf
    assert (bins[:2] == n_bins - 1).all() and (bins[2] == n_bins - 1).all()


@pytest.mark.parametrize("seed,T,D,n_bins,M", [
    (0, 150, 4, 64, 300), (1, 1, 1, 64, 50), (2, 20, 6, 16, 200), (3, 7, 3, 2, 40),
])
def test_kernel_walk_equals_twin(seed, T, D, n_bins, M):
    """The kernel's walk, written out: every row reaches the twin's leaf in
    every tree (leaves are distinct normal draws), and its score is the
    twin's leaves summed in float64 runs of trees, rounded once; within
    the float32 sum's rounding bound of the twin's score. Features hold
    NaN, +-inf, -0.0, exact edges and values beyond the last edge; a
    tenth of the splits are no-ops."""
    g = torch.Generator().manual_seed(seed)
    F = 104
    edges = torch.sort(torch.randn((F, n_bins - 1), generator=g) * 3, dim=1).values
    edges[torch.rand(F, generator=g) < 0.2, -3:] = torch.inf
    W = 2 ** (D - 1)
    gfeat = torch.randint(0, F, (T, D, W), generator=g, dtype=torch.int32)
    thr = torch.randint(1, n_bins, (T, D, W), generator=g, dtype=torch.int32)
    thr[torch.rand((T, D, W), generator=g) < 0.1] = n_bins
    leaf = 0.1 * torch.randn((T, 2 ** D), generator=g)
    x = torch.randn((M, F), generator=g) * 4
    pick = torch.rand((M, F), generator=g)
    e = edges[torch.arange(F), torch.randint(0, n_bins - 1, (F,), generator=g)]
    x = torch.where(pick < 0.1, e.expand(M, -1), x)
    special = torch.tensor([math.nan, math.inf, -math.inf, -0.0, 1e6])
    x = torch.where((pick >= 0.1) & (pick < 0.15),
                    special[torch.randint(0, 5, (M, F), generator=g)], x)
    got, got_val = walk_as_kernel(x, edges, gfeat, thr, leaf)
    val = gbdt._leaf_values(gbdt._bin_program(x, edges), gfeat, thr, leaf)
    assert torch.equal(got_val, val)
    twin = gbdt._predict_program(x, edges, gfeat, thr, leaf)
    assert torch.equal(val.sum(dim=1), twin)
    assert torch.equal(got, kernel_sum(val))
    bound = (T - 1) * 2.0 ** -24 * val.abs().sum(dim=1).double()
    assert ((got.double() - twin.double()).abs() <= bound).all()


def test_smem_budget():
    """The serving shape (F 104, T 150, D 4) leaves room for two blocks an
    SM; D 6 at T 150 fits one; T 1000 at D 4 does not fit."""
    parts = 8 * 128 * 3
    assert k5.smem_bytes(104, 150, 4) == parts + 4 * 128 * 105 + 8 * 150 * 15 + 4 * 150 * 16
    assert 2 * k5.smem_bytes(104, 150, 4) <= k5.SMEM_BYTES
    assert k5.smem_bytes(104, 150, 6) <= k5.SMEM_BYTES
    assert k5.smem_bytes(104, 1000, 4) > k5.SMEM_BYTES
    # an odd row stride with a spare column, for even and odd F
    assert k5.smem_bytes(105, 1, 1) == parts + 4 * 128 * 107 + 8 + 8


@pytest.mark.parametrize("T", [1, 3, 4, 5, 150, 151])
def test_leaf_sum_order_covers_every_tree_once(T):
    runs = k5.leaf_sum_order(T)
    assert len(runs) == k5.PARTS
    assert [t for a, b in runs for t in range(a, b)] == list(range(T))


def _args(M=5, F=6, T=3, D=2, n_bins=8):
    return dict(
        feats=torch.zeros((M, F), dtype=F32),
        edges=torch.zeros((F, n_bins - 1), dtype=F32),
        gfeat=torch.zeros((T, D, 2 ** (D - 1)), dtype=torch.int32),
        thr=torch.ones((T, D, 2 ** (D - 1)), dtype=torch.int32),
        leaf=torch.zeros((T, 2 ** D), dtype=F32),
    )


BAD_CALLS = {
    "feats_float64": (TypeError, lambda a: a.update(feats=a["feats"].double())),
    "feats_bfloat16": (TypeError, lambda a: a.update(feats=a["feats"].bfloat16())),
    "edges_float64": (TypeError, lambda a: a.update(edges=a["edges"].double())),
    "gfeat_int64": (TypeError, lambda a: a.update(gfeat=a["gfeat"].long())),
    "thr_int64": (TypeError, lambda a: a.update(thr=a["thr"].long())),
    "leaf_float16": (TypeError, lambda a: a.update(leaf=a["leaf"].half())),
    "feats_numpy": (TypeError, lambda a: a.update(feats=a["feats"].numpy())),
    "feats_1d": (ValueError, lambda a: a.update(feats=a["feats"].reshape(-1))),
    "feats_3d": (ValueError, lambda a: a.update(feats=a["feats"][None])),
    "edges_features": (ValueError, lambda a: a.update(edges=a["edges"][:-1])),
    "gfeat_width": (ValueError, lambda a: a.update(gfeat=torch.zeros((3, 2, 3), dtype=torch.int32))),
    "thr_shape": (ValueError, lambda a: a.update(thr=a["thr"][:-1])),
    "leaf_shape": (ValueError, lambda a: a.update(leaf=a["leaf"][:, :-1])),
    "depth_zero": (ValueError, lambda a: a.update(gfeat=torch.zeros((3, 0, 1), dtype=torch.int32),
                                                  thr=torch.ones((3, 0, 1), dtype=torch.int32))),
    "feats_transposed": (ValueError, lambda a: a.update(feats=torch.zeros((6, 5)).t())),
    "edges_strided": (ValueError, lambda a: a.update(edges=torch.zeros((6, 14))[:, ::2])),
    "leaf_strided": (ValueError, lambda a: a.update(leaf=torch.zeros((3, 8))[:, ::2])),
    "over_smem": (ValueError, lambda a: a.update(**_args(T=1000, D=4, F=104))),
    "two_devices": (ValueError, lambda a: a.update(feats=a["feats"].to("meta"))),
    "cpu": (ValueError, lambda a: None),
}


@pytest.mark.parametrize("fault", sorted(BAD_CALLS))
def test_wrapper_refuses_what_the_kernel_does_not_take(fault):
    """A wrong dtype, shape, layout or device, or trees beyond a block's
    shared memory, raise before any launch; CPU tensors go to the twin
    through GBDTRanker, never through the wrapper."""
    err, fault_fn = BAD_CALLS[fault]
    a = _args()
    fault_fn(a)
    before = k5.LAUNCHES.value
    with pytest.raises(err, match="gbdt_walk"):
        k5.gbdt_walk(**a)
    assert k5.LAUNCHES.value == before


def test_cpu_scores_take_the_twin():
    """predict_scores_device on a CPU tensor runs `_predict_program` (bit
    for bit) and launches nothing."""
    g = torch.Generator().manual_seed(5)
    F, T, D, n_bins = 104, 30, 4, 64
    edges = torch.sort(torch.randn((F, n_bins - 1), generator=g), dim=1).values
    gfeat = torch.randint(0, F, (T, D, 8), generator=g, dtype=torch.int32)
    thr = torch.randint(1, n_bins + 1, (T, D, 8), generator=g, dtype=torch.int32)
    leaf = torch.randn((T, 16), generator=g)
    r = gbdt.GBDTRanker(gbdt.GBDTConfig(n_trees=T, max_depth=D, n_bins=n_bins),
                        edges.numpy(), gfeat.numpy(), thr.numpy(), leaf.numpy(),
                        tuple(f"f{i}" for i in range(F)))
    x = torch.randn((4, 7, F), generator=g)
    before = k5.LAUNCHES.value
    got = r.predict_scores_device(x)
    assert k5.LAUNCHES.value == before
    assert got.shape == (4, 7)
    assert torch.equal(got.reshape(-1), gbdt._predict_program(x.reshape(-1, F), edges, gfeat,
                                                                thr, leaf))


def test_ranker_tensors_are_contiguous():
    """Trained edges come column-major (`compute_bin_edges` transposes its
    quantiles); the ranker's tensors, which K5 reads, are contiguous."""
    feats = np.random.default_rng(1).normal(size=(500, 3)).astype(np.float32)
    edges = gbdt.compute_bin_edges(feats, 8)
    assert not edges.flags.c_contiguous
    r = gbdt.GBDTRanker(gbdt.GBDTConfig(n_trees=2, max_depth=2, n_bins=8), edges,
                        np.zeros((2, 2, 2), np.int32), np.ones((2, 2, 2), np.int32),
                        np.zeros((2, 4), np.float32), ("a", "b", "c"))
    got = r.tensors(torch.device("cpu"))
    assert all(t.is_contiguous() for t in got)
    assert np.array_equal(got[0].numpy(), edges)


def test_ranker_refuses_edges_the_walk_cannot_search():
    """Edges that are NaN or not ascending are refused when the ranker is
    made: binary search and K5's one-edge decision both need them sorted."""
    F, n_bins = 3, 4
    good = np.sort(np.random.default_rng(0).normal(size=(F, n_bins - 1)), 1).astype(np.float32)
    make = lambda e: gbdt.GBDTRanker(  # noqa: E731
        gbdt.GBDTConfig(n_trees=1, max_depth=1, n_bins=n_bins), e,
        np.zeros((1, 1, 1), np.int32), np.ones((1, 1, 1), np.int32),
        np.zeros((1, 2), np.float32), ("a", "b", "c"))
    make(good)
    for bad in (good[:, ::-1].copy(), np.where(np.arange(3) == 1, np.nan, good)):
        with pytest.raises(ValueError, match="edges"):
            make(bad.astype(np.float32))
