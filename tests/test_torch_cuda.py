"""The CUDA kernels against their plain twins, on the card.

Marked `cuda`: each test skips where no CUDA device is present (decided in
the fixture, at run time). This file imports no jax, so it runs on a
machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which configures jax.)
"""
import pytest
import torch

from otto_tpu_torch.ops.kernels import _build, dma_gather, gather, gbdt_walk, mips, segscan
import torch_threads  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


# K1's edges: the walk's and the sort's shapes, S = 1, S not a multiple of
# the tile rows (10007 rows in 36-row tiles, 20011 in 24-row tiles), odd P
# and W (tiles whose bytes are not a multiple of 16: the kernel's own
# word-by-word path), B = 1 and B at the column-pointer limit, P at the
# shared-memory limit (one source row and one index row of W = 8 fill a
# block's 232,448 bytes: a one-stage ring)
K1_P_MAX = (gather.SMEM_BYTES - 16) // 4 - 8


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["stacked", "list", "odd_views"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize(
    "B,S,P,W", [(3, 9, 300, 300), (1, 1000, 104, 150), (2, 7, 4000, 4000),
                (2, 5, 15000, 3), (1, 1, 104, 150), (3, 1, 4096, 4096),
                (1, 10007, 104, 150), (2, 20011, 301, 151), (5, 17, 7, 5),
                (gather.MAX_COLS, 9, 36, 17), (1, 3, K1_P_MAX, 8)],
)
def test_cuda_gather_matches_twin(cuda_device, dtype, B, S, P, W, form):
    """Random 32-bit words (as float32: NaNs with payloads, infinities,
    denormals) through the kernel, stacked, as a list of columns and as a
    list of views at an odd word offset (no column 16-byte aligned): bit
    for bit the twin's, compared as int32 words, and the list forms equal
    to the stacked form."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    words = torch.randint(-2**31, 2**31 - 1, (B * S * P + 1,), generator=g,
                          device=cuda_device, dtype=torch.int32)
    vals = words[:B * S * P].view(B, S, P).view(dtype)
    if form == "stacked":
        arg = vals
    elif form == "list":
        arg = [vals[b].clone() for b in range(B)]
    else:
        arg = [words[1 + b * S * P:1 + (b + 1) * S * P].view(S, P).view(dtype)
               for b in range(B)]
        vals = torch.stack(arg)
    idx = torch.randint(0, P, (S, W), generator=g, device=cuda_device,
                        dtype=torch.int32)
    before = gather.LAUNCHES.value
    got = gather.gather_rows(arg, idx, check=True)
    torch.cuda.synchronize()
    assert gather.LAUNCHES.value == before + 1
    want = gather.gather_rows_ref(arg, idx)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if form != "stacked":
        stacked = gather.gather_rows(vals, idx)
        assert torch.equal(got.view(torch.int32), stacked.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("red", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("P", [1, 31, 1000])
def test_cuda_segscan_matches_twin(cuda_device, red, dtype, P):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    B, S = 3, 9
    vals = torch.randint(-50, 50, (B, S, P), generator=g,
                         device=cuda_device).to(dtype)
    first = torch.rand((S, P), generator=g, device=cuda_device) < 0.05
    before = segscan.LAUNCHES.value
    got = segscan.segmented_scan(vals, first, red)
    torch.cuda.synchronize()
    assert segscan.LAUNCHES.value == before + 1
    # small integer values: float sums are exact in any order here
    assert torch.equal(got, segscan.segmented_scan_ref(vals, first, red))


# K3 scores: 3xTF32 tensor-core sums (about 2^-21 relative per product)
# against cuBLAS's float32 sums, far inside this tolerance of the terms
# |q|^2 + |c|^2 (~200 at D = 100); an index may differ from the twin's only
# where the kernel's pick scores, recomputed in float64, within that
# tolerance of the twin's entry (a near-tie summed in another order)
MIPS_TOL = 1e-4


def assert_topk_agree(got, want, q, c, metric):
    gs, gi = got
    ws, wi = want
    scale = 1.0 + float(ws.abs().max()) if ws.numel() else 1.0
    assert torch.allclose(gs, ws, rtol=0, atol=MIPS_TOL * scale)
    diff = gi != wi
    if diff.any():
        rows = diff.nonzero()[:, 0]
        qq, cc = q[rows].double(), c[gi[diff].long()].double()
        s = (qq * cc).sum(1)
        if metric == "l2":
            s = 2 * s - (qq * qq).sum(1) - (cc * cc).sum(1)
        assert torch.allclose(s, ws[diff].double(), rtol=0, atol=MIPS_TOL * scale)
        assert int(diff.sum()) <= max(2, diff.numel() // 1000)


def n_sm(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("Q,V,D,k", [
    (1, 1000, 100, 20),      # one query
    (333, 1000, 100, 20),    # V and Q not tile multiples
    (64, 7, 100, 20),        # V < k: -1 entries
    (3, 0, 8, 4),            # empty corpus
    (200, 4097, 128, 20),    # D = 128
    (130, 3000, 16, 5),
    (65, 300, 100, 32),      # the largest k
    (300, 5000, 3, 20),      # D = 3: depths past D masked
    (100, 2500, 57, 20),     # D neither a multiple of 4 nor of 8
    (129, 2000, 8, 1),       # k = 1
    (257, 3000, mips.MAX_D, 32),   # the largest D at the largest k
    (40, 30, 100, 32),       # V < k = 32
    (2, 0, 100, 20),
])
def test_cuda_mips_matches_twin(cuda_device, metric, Q, V, D, k):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q = torch.randn((Q, D), generator=g, device=cuda_device)
    c = torch.randn((V, D), generator=g, device=cuda_device)
    before = mips.LAUNCHES.value
    got = mips.mips_topk(q, c, k, metric)
    torch.cuda.synchronize()
    assert mips.LAUNCHES.value == before + 1
    want = mips.mips_topk_ref(q, c, k, metric)
    assert got[0].shape == (Q, k) and got[1].dtype == torch.int32
    assert_topk_agree(got, want, q, c, metric)
    if V < k:
        assert (got[1][:, V:] == -1).all() and (got[0][:, V:] == mips.NEG_INF).all()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("Q", [1, 64, 1000])
@pytest.mark.parametrize("k", [1, 20, 32])
def test_cuda_mips_split_matches_twin(cuda_device, metric, Q, k):
    """Few query blocks: the corpus is split across blocks and merged."""
    V, D = 100_003, 100
    S, _ = mips.split_plan(Q, V, n_sm(cuda_device))
    assert S > 1
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q = torch.randn((Q, D), generator=g, device=cuda_device) * 0.3
    c = torch.randn((V, D), generator=g, device=cuda_device) * 0.3
    got = mips.mips_topk(q, c, k, metric)
    torch.cuda.synchronize()
    assert_topk_agree(got, mips.mips_topk_ref(q, c, k, metric), q, c, metric)


@pytest.mark.cuda
def test_cuda_mips_tie_lower_index_first(cuda_device):
    """Identical rows 10, 700 and 1500, in three different 64-row tiles;
    then identical rows in three different corpus splits."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    c = torch.randn((2000, 100), generator=g, device=cuda_device)
    c[700] = c[10]
    c[1500] = c[10]
    q = c[[10, 700]].clone()
    s, i = mips.mips_topk(q, c, 5)
    torch.cuda.synchronize()
    assert i[:, :3].tolist() == [[10, 700, 1500]] * 2
    assert torch.equal(i, mips.mips_topk_ref(q, c, 5)[1])

    V = 100_000
    S, chunk = mips.split_plan(2, V, n_sm(cuda_device))
    assert S >= 3
    c = torch.randn((V, 100), generator=g, device=cuda_device)
    rows = [chunk - 1, chunk, 2 * chunk + 5]   # either side of a boundary, and a third split
    c[rows[1]] = c[rows[0]]
    c[rows[2]] = c[rows[0]]
    for metric in ("l2", "dot"):
        q = c[rows[::-1]].clone()
        s, i = mips.mips_topk(q, c, 5, metric)
        torch.cuda.synchronize()
        assert i[:, :3].tolist() == [rows] * 3
        assert torch.equal(i, mips.mips_topk_ref(q, c, 5, metric)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("V,D,N,dtype", [
    (1000, 100, 777, torch.float32),
    (1000, 128, 300, torch.int32),
    (50, 3, 1000, torch.float32),      # D % 4 != 0: 4-byte loads
    (1, 100, 5, torch.int32),
    (10, 100, 0, torch.float32),
])
def test_cuda_gather_hbm_matches_twin(cuda_device, V, D, N, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    table = torch.randint(-2**31, 2**31 - 1, (V, D), generator=g, device=cuda_device,
                          dtype=torch.int32)
    if dtype == torch.float32:
        table = torch.randn((V, D), generator=g, device=cuda_device)
    ids = torch.randint(-5, V + 5, (N,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    before = dma_gather.LAUNCHES.value
    got = dma_gather.gather_rows_hbm(table, ids)
    torch.cuda.synchronize()
    assert dma_gather.LAUNCHES.value == before + (1 if N else 0)
    assert torch.equal(got, dma_gather.gather_rows_hbm_ref(table, ids))


@pytest.mark.cuda
def test_cuda_gather_hbm_unaligned_table(cuda_device):
    """A table that starts 4 bytes into its storage takes 4-byte loads."""
    V, D = 300, 100
    base = torch.randn(V * D + 1, device=cuda_device)
    table = base[1:].view(V, D)
    assert table.data_ptr() % 16 != 0
    ids = torch.randint(0, V, (1000,), device=cuda_device, dtype=torch.int32)
    got = dma_gather.gather_rows_hbm(table, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, dma_gather.gather_rows_hbm_ref(table, ids))


# K5: the GBDT walk against the twin (models/gbdt.py: _bin_program, the
# walk on K1, the float32 sum). The tolerance on the leaf sum: the kernel
# adds the T leaves in float64 in runs of trees (gbdt_walk.leaf_sum_order)
# and rounds once, so it is bit for bit (0 ulps) the twin's leaves summed
# that way; against the twin's own float32 sum it lies within that sum's
# rounding bound, (T - 1) 2^-24 sum |leaf| (at most (T - 1) / 2 ulps of
# sum |leaf|).
def gbdt_case(dev, seed, M, T, D, n_bins, F=104):
    """Edges of the serving cells' kind (ascending, a fifth of the features
    +inf padded), a tenth of the splits no-ops (thr == n_bins), features
    holding NaN, +-inf, -0.0, exact edges and values beyond the last edge."""
    g = torch.Generator(device=dev).manual_seed(seed)
    edges = torch.sort(torch.randn((F, n_bins - 1), generator=g, device=dev) * 3,
                       dim=1).values
    edges[torch.rand(F, generator=g, device=dev) < 0.2, -3:] = torch.inf
    W = 2 ** (D - 1)
    gfeat = torch.randint(0, F, (T, D, W), generator=g, device=dev, dtype=torch.int32)
    thr = torch.randint(1, n_bins, (T, D, W), generator=g, device=dev, dtype=torch.int32)
    thr[torch.rand((T, D, W), generator=g, device=dev) < 0.1] = n_bins
    leaf = 0.1 * torch.randn((T, 2 ** D), generator=g, device=dev)
    x = torch.randn((M, F), generator=g, device=dev) * 4
    pick = torch.rand((M, F), generator=g, device=dev)
    e = edges[torch.arange(F, device=dev),
              torch.randint(0, n_bins - 1, (F,), generator=g, device=dev)]
    x = torch.where(pick < 0.1, e.expand(M, -1), x)
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 1e6,
                            float(edges[torch.isfinite(edges)].max()) * 2], device=dev)
    x = torch.where((pick >= 0.1) & (pick < 0.15),
                    special[torch.randint(0, len(special), (M, F), generator=g, device=dev)], x)
    return x, edges, gfeat, thr, leaf


def assert_walk_matches_twin(x, edges, gfeat, thr, leaf, got):
    from otto_tpu_torch.models import gbdt

    val = gbdt._leaf_values(gbdt._bin_program(x, edges), gfeat, thr, leaf)
    acc = torch.zeros(x.shape[0], dtype=torch.float64, device=x.device)
    for a, b in gbdt_walk.leaf_sum_order(val.shape[1]):
        run = torch.zeros_like(acc)
        for t in range(a, b):
            run += val[:, t].double()
        acc += run
    assert torch.equal(got, acc.float())
    twin = val.sum(dim=1)
    bound = (val.shape[1] - 1) * 2.0 ** -24 * val.abs().sum(dim=1).double()
    assert ((got.double() - twin.double()).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("M,T,D,n_bins", [
    (1 << 20, 150, 4, 64),          # the serving shape: 2,048 sessions x 512
    (1, 150, 4, 64), (255, 150, 4, 64), (1_000_003, 150, 4, 64), (0, 150, 4, 64),
    (1000, 1, 1, 64), (10007, 150, 6, 64), (3000, 37, 4, 2),
])
def test_cuda_gbdt_walk_matches_twin(cuda_device, M, T, D, n_bins):
    x, edges, gfeat, thr, leaf = gbdt_case(cuda_device, 11, M, T, D, n_bins)
    before = gbdt_walk.LAUNCHES.value
    got = gbdt_walk.gbdt_walk(x, edges, gfeat, thr, leaf)
    torch.cuda.synchronize()
    assert gbdt_walk.LAUNCHES.value == before + (1 if M else 0)
    assert got.shape == (M,) and got.dtype == torch.float32
    assert_walk_matches_twin(x, edges, gfeat, thr, leaf, got)


@pytest.mark.cuda
def test_cuda_gbdt_walk_identical_rows(cuda_device):
    """One row copied over 40,000 rows (313 tiles, each block's tiles at
    other places of its loop) scores the same everywhere."""
    x, edges, gfeat, thr, leaf = gbdt_case(cuda_device, 12, 8, 150, 4, 64)
    rows = x[3:4].expand(40_000, -1).contiguous()
    got = gbdt_walk.gbdt_walk(rows, edges, gfeat, thr, leaf)
    torch.cuda.synchronize()
    assert torch.equal(got, got[:1].expand(40_000))
    assert_walk_matches_twin(rows[:1], edges, gfeat, thr, leaf, got[:1])


@pytest.mark.cuda
def test_cuda_gbdt_ranker_runs_only_k5(cuda_device):
    """GBDTRanker.predict_scores_device on CUDA features launches K5 once a
    call and no K1, and gives the wrapper's scores."""
    from otto_tpu_torch.config import GBDTConfig
    from otto_tpu_torch.models.gbdt import GBDTRanker

    x, edges, gfeat, thr, leaf = gbdt_case(cuda_device, 13, 64 * 512, 150, 4, 64)
    r = GBDTRanker(GBDTConfig(), edges.cpu().numpy(), gfeat.cpu().numpy(),
                   thr.cpu().numpy(), leaf.cpu().numpy(),
                   tuple(f"f{i}" for i in range(x.shape[1])))
    feats = x.view(64, 512, -1)
    k1, k5 = gather.LAUNCHES.value, gbdt_walk.LAUNCHES.value
    got = [r.predict_scores_device(feats) for _ in range(3)]
    torch.cuda.synchronize()
    assert gbdt_walk.LAUNCHES.value == k5 + 3
    assert gather.LAUNCHES.value == k1
    assert got[0].shape == (64, 512)
    want = gbdt_walk.gbdt_walk(x, edges, gfeat, thr, leaf).view(64, 512)
    assert all(torch.equal(s, want) for s in got)


@pytest.mark.cuda
def test_cuda_gbdt_walk_refuses_trees_beyond_smem(cuda_device):
    """The library's shared-memory count is the wrapper's; trees that do
    not fit a block raise before any launch."""
    lib = _build.load()
    for F, T, D in ((104, 150, 4), (104, 150, 6), (105, 1, 1), (3, 7, 9)):
        assert lib.otto_gbdt_walk_smem(F, T, D) == gbdt_walk.smem_bytes(F, T, D)
    x, edges, gfeat, thr, leaf = gbdt_case(cuda_device, 14, 100, 1000, 4, 64)
    before = gbdt_walk.LAUNCHES.value
    with pytest.raises(ValueError, match="shared memory"):
        gbdt_walk.gbdt_walk(x, edges, gfeat, thr, leaf)
    assert gbdt_walk.LAUNCHES.value == before


# ---------------------------------------------------------------------------
# co-visitation counting and popularity: the card's torch ops against the CPU
# ---------------------------------------------------------------------------
def _flat_keys(g, n):
    k1 = torch.randint(-8, 8, (n,), generator=g, dtype=torch.int32)
    k2 = torch.randint(-8, 8, (n,), generator=g, dtype=torch.int32)
    m = min(n, 3)
    k1[:m] = torch.tensor([-2**31, 2**31 - 2, 2**31 - 1], dtype=torch.int32)[:m]
    k2[:m] = torch.tensor([2**31 - 2, -2**31, 2**31 - 1], dtype=torch.int32)[:m]
    v = torch.randint(-2**30, 2**30, (n,), generator=g, dtype=torch.int32)
    return k1, k2, v


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 1 << 20])
def test_cuda_flat_groupbys_match_cpu(cuda_device, n):
    """Composite-key sorts, wrapping int32 segment sums, compaction, ranks
    and the dense top-N scatter: bit-equal to the same ops on the CPU."""
    from otto_tpu_torch.ops import segment as seg

    g = torch.Generator().manual_seed(n)
    k1, k2, v = _flat_keys(g, n)
    want = seg.sort_compress(k1, k2, v)
    got = seg.sort_compress(k1.to(cuda_device), k2.to(cuda_device), v.to(cuda_device))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    rank = seg.ordinal_rank_desc(k1, k2, v > 0)
    assert torch.equal(seg.ordinal_rank_desc(
        k1.to(cuda_device), k2.to(cuda_device), (v > 0).to(cuda_device)).cpu(), rank)
    key = torch.where(v > 0, k1.abs() % 50, seg.SENTINEL)
    want_t = seg.build_topn_tables(key, k2, (v,), 50, 4)
    got_t = seg.build_topn_tables(key.to(cuda_device), k2.to(cuda_device),
                                  (v.to(cuda_device),), 50, 4)
    assert torch.equal(got_t[0].cpu(), want_t[0]) and torch.equal(got_t[1][0].cpu(), want_t[1][0])


@pytest.mark.cuda
@pytest.mark.parametrize("spill,prune", [(True, 1_000), (True, 0), (False, 0)])
def test_cuda_covis_and_popularity_match_cpu(cuda_device, spill, prune):
    import dataclasses

    import numpy as np

    from otto_tpu_torch.config import CoVisConfig, PopularityConfig
    from otto_tpu_torch.data.synthetic import SyntheticSpec, generate_device
    from otto_tpu_torch.engine import baseline
    from otto_tpu_torch.engine.covis import CoVisCounter
    from otto_tpu_torch.engine.popularity import compute_popularity

    ev = generate_device(SyntheticSpec(n_sessions=800, n_aids=3000, max_len=64, seed=3), cuda_device)
    cfg = dataclasses.replace(CoVisConfig(), pair_budget=1 << 14, max_run_rows=1 << 17,
                              host_spill=spill, spill_prune_min_rows=prune,
                              accumulator_capacity=1 << 13)
    out = []
    for device in (cuda_device, torch.device("cpu")):
        counter = CoVisCounter(cfg, device)
        counter.update(ev)
        tables = counter.retrieval_tables(3000)
        counter.close()
        pop = compute_popularity(ev, (ev.session % 7).astype(np.int32), 7, 3000,
                                 PopularityConfig(), device, event_budget=1 << 12)
        rec = baseline.recommend(ev, tables, batch_sessions=128)
        out.append((tables, pop, rec, counter.ladder.rows_pruned))
    (t_d, p_d, r_d, pr_d), (t_c, p_c, r_c, pr_c) = out
    assert pr_d == pr_c and (pr_c > 0) == (spill and prune > 0)
    for name in cfg.names:
        for a, b in zip(t_d[name], t_c[name]):
            assert torch.equal(a.cpu(), b), name
    for a, b in zip(p_d, p_c):
        assert torch.equal(a.cpu(), b)
    assert np.array_equal(r_d[0], r_c[0]) and np.array_equal(r_d[1], r_c[1])


# ---------------------------------------------------------------------------
# the training path: pass A's programs and GBDT training, card against CPU
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_histograms_match_cpu(cuda_device):
    """Exact fixed-point sums: bit-equal on both devices, in any row order."""
    from otto_tpu_torch.models import gbdt

    g = torch.Generator().manual_seed(6)
    n = 300_000
    bins = torch.randint(0, 64, (n, 7), generator=g, dtype=torch.uint8)
    bins[:, 0] = 0                                   # one hot cell
    node = torch.randint(0, 8, (n,), generator=g)
    gh = torch.randn((n, 3), generator=g) * torch.exp(torch.randn((n, 1), generator=g) * 4)
    want = gbdt._histograms(bins, node, gh, 8, 64)
    perm = torch.randperm(n, generator=g)
    for rows in (torch.arange(n), perm):
        got = gbdt._histograms(bins[rows].to(cuda_device), node[rows].to(cuda_device),
                               gh[rows].to(cuda_device), 8, 64)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_pass_a_programs_match_cpu(cuda_device):
    import numpy as np

    from otto_tpu_torch.data.schema import Labels
    from otto_tpu_torch.engine import retrieval
    from otto_tpu_torch.eval.per_source import DeviceSourceEval

    rng = np.random.default_rng(7)
    S, C = 3000, 64
    cand = rng.integers(-1, 5000, (S, C)).astype(np.int32)
    session = (np.arange(S) * 7 + 4000).astype(np.int32)
    feats = rng.normal(size=(S, C, len(retrieval.FEATURE_NAMES))).astype(np.float32) * 1e5
    hit = rng.random((S, C)) < 0.05
    si, ci = np.nonzero(hit & (cand >= 0))
    labels = Labels(session[si], rng.integers(0, 3, len(si)), cand[si, ci])
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        b = retrieval.RetrievedBatch(session, torch.from_numpy(cand).to(dev),
                                     torch.from_numpy(feats).to(dev), torch.from_numpy(cand).to(dev))
        meta, bits = b.pack_meta_labels(retrieval.label_keys_device(labels, dev))
        ev = DeviceSourceEval(C, dev)
        ev.update(meta, bits)
        rows, _ = b.feats_rows_async(si, ci)
        out.append((meta.cpu(), bits.cpu(), ev.hits.cpu(), ev.hist.cpu(), np.asarray(rows)))
    for a, c in zip(*out):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, c)
        else:
            assert a.tobytes() == c.tobytes()
    assert int(out[1][1].count_nonzero()) >= len(si) // 2


@pytest.mark.cuda
def test_cuda_gbdt_training_is_deterministic(cuda_device):
    """Two trainings on the card from the same seed: identical trees."""
    import numpy as np

    from otto_tpu_torch.config import GBDTConfig
    from otto_tpu_torch.models import gbdt

    rng = np.random.default_rng(8)
    n_groups, g = 3000, 40
    x = rng.normal(size=(n_groups * g, 30)).astype(np.float16)
    logit = x[:, 0].astype(np.float32) + (x[:, 1] > 0) * x[:, 2]
    y = (logit + rng.normal(size=len(x)) > 2.0).astype(np.int8)
    sess = np.repeat(np.arange(n_groups), g)
    cfg = GBDTConfig(n_trees=12, eval_every=4, group_chunk=256)
    valid = (x[:4000], y[:4000], sess[:4000])
    a, b = (gbdt.train_gbdt_ranker(x, y, sess, tuple(map(str, range(30))), cfg,
                                   valid=valid, device=cuda_device) for _ in range(2))
    for k in ("gfeat", "thr", "leaf", "gains"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert a.eval_history == b.eval_history and (a.thr < cfg.n_bins).any()


@pytest.mark.cuda
@pytest.mark.parametrize("sharing", ["chunk", "pair"])
def test_cuda_sgns_training_deterministic_and_near_cpu(cuda_device, sharing):
    """Two card trainings of the same corpus are bit-identical (a row's
    updates are summed exactly in int64 fixed point, not by float
    atomics); one step from the same draws on the card and on the CPU
    agrees within the ulps of cuBLAS vs the CPU's products."""
    import numpy as np

    from otto_tpu_torch.config import Word2VecConfig
    from otto_tpu_torch.data.synthetic import SyntheticSpec, generate_device
    from otto_tpu_torch.models import word2vec as w2v

    cpu = torch.device("cpu")
    ev = generate_device(SyntheticSpec(n_sessions=3000, n_aids=5000, max_len=64, mean_len=12,
                                seed=9), cpu)
    cfg = Word2VecConfig(name="x", vector_size=32, min_count=1, epochs=2,
                         batch_size=8192, neg_sharing=sharing)
    a, b = (w2v.train_word2vec_device(ev, cfg, 5000, device=cuda_device) for _ in range(2))
    assert a.report.mode == ("block" if sharing == "chunk" else "pair")
    assert np.array_equal(a.emb, b.emb)
    assert np.isfinite(a.report.epoch_loss).all()

    vocab = w2v.build_vocab(ev, cfg.types, 1, 5000)
    words, cum = w2v.flat_corpus(ev, vocab, cfg.types)
    V, N = vocab.size, len(words)
    g = torch.Generator().manual_seed(3)
    state = [torch.randn((V, 32), generator=g) * 0.3, torch.randn((V, 32), generator=g) * 0.3,
             torch.rand(V, generator=g) + 0.01, torch.rand(V, generator=g) + 0.01]
    if sharing == "chunk":
        prob, alias = w2v.make_alias(vocab.counts)
        host = [torch.from_numpy(x).long() for x in (words, w2v.pack_position_info(cum))]
        host += [torch.from_numpy(prob), torch.from_numpy(alias).long()]
        d = w2v.block_draws(g, 2048, 4, 10, N, V, 32 * 64)
    else:
        host = [torch.from_numpy(words).long(), torch.from_numpy(cum).long(),
                torch.from_numpy(w2v.make_neg_cdf(vocab.counts))]
        d = w2v.pair_draws(g, 8192, 10, (8192, 8))
    keep = torch.from_numpy(w2v.keep_probs(vocab.counts, 1e-3))
    out = []
    for dev in (cuda_device, cpu):
        p = w2v.SGNSParams(*(t.to(dev).clone() for t in state))
        args = [t.to(dev) for t in host] + [keep.to(dev), 0.25]
        dd = {k: v.to(dev) for k, v in d.items()}
        if sharing == "chunk":
            loss = w2v._block_step(p, *args, 4, 8, dd)
        else:
            loss = w2v._pair_step(p, *args, 8192, 8, dd, "pair")
        out.append(([t.cpu() for t in p], float(loss)))
    (got, loss_d), (want, loss_c) = out
    for x, y in zip(got, want):
        assert torch.allclose(x, y, rtol=1e-5, atol=1e-6)
    assert abs(loss_d - loss_c) <= 1e-5 * abs(loss_c)


# ---------------------------------------------------------------------------
# the pipeline on the card: the artifact cache and the overlapped consumer
# ---------------------------------------------------------------------------
def _small_config():
    import dataclasses

    from otto_tpu_torch.config import (Config, CoVisConfig, GBDTConfig, KMeansConfig,
                                       RetrievalConfig, Word2VecConfig)

    w2v = {n: Word2VecConfig(name=n, types=t, vector_size=16, window=4, min_count=2,
                             epochs=1, batch_size=4096, steps_per_dispatch=1, knn_k=10,
                             knn_first_n_aids=2000)
           for n, t in (("wall", (0, 1, 2)), ("w12", (1, 2)))}
    return Config(covis=dataclasses.replace(CoVisConfig(), accumulator_capacity=1 << 17),
                  retrieval=RetrievalConfig(max_session_aids=16, max_candidates=128,
                                            session_len_buckets=(8, 32)),
                  w2vec=w2v, kmeans=dataclasses.replace(KMeansConfig(), max_iter=10),
                  gbdt=GBDTConfig(n_trees=10, max_depth=3, n_bins=16, max_group=64))


@pytest.mark.cuda
def test_cuda_build_cache_round_trip_and_overlapped_pass_a(cuda_device, tmp_path):
    """A small build on the card writes its artifact cache; a second build
    from that cache gives bit-equal tables. Pass A overlapped (consumer
    thread and stream) and in turn on one thread: rows, label bits,
    counters and reports bit-equal; so are two score passes."""
    import json
    import os

    import numpy as np

    from otto_tpu_torch.config import TYPES
    from otto_tpu_torch.data.split import split_events
    from otto_tpu_torch.data.synthetic import SyntheticSpec, generate
    from otto_tpu_torch.pipeline import runner

    cfg = _small_config()
    sp = split_events(generate(SyntheticSpec(n_sessions=3000, n_aids=2000, mean_len=10,
                                             seed=4)), 7, 42)

    def build():
        return runner.build_retriever(
            sp.train, sp.test, 2000, cuda_device, cfg.w2vec, None, cfg.covis, cfg.popularity,
            cfg.retrieval, cfg.kmeans, cache_dir=str(tmp_path))

    first, rep1 = build()
    second, rep2 = build()
    assert len(rep1.cache["written"]) == 7 and not rep1.cache["loaded"]
    assert len(rep2.cache["loaded"]) == 7 and not rep2.cache["written"]
    for a, b in zip(first.ctx.tensors(), second.ctx.tensors()):
        assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b)
    for f in ("ids", "cluster", "emb"):
        assert np.array_equal(getattr(first.sessions, f), getattr(second.sessions, f))

    out = {}
    for overlap in (True, False):
        work = tmp_path / f"pass_a_{overlap}"
        work.mkdir()
        metrics, rep = runner.pass_a(second, sp.test, sp.labels, cfg.ranker, str(work),
                                     batch_sessions=128, overlap=overlap)
        files = {n: (work / n).read_text() for n in
                 ("eval_retrieved.json", "eval_retrieved_sources.json", "passA-metrics.json")}
        rows = {t: {k: v.tobytes() for k, v in np.load(work / f"downsampled-{t}.npz").items()}
                for t in TYPES}
        out[overlap] = (metrics, rep.rows, files, rows)
    assert out[True] == out[False]
    assert rep.batches > 4 and all(n > 0 for n in rep.rows.values())

    rankers = {t: runner.train_ranker_cached(
        str(tmp_path / "pass_a_True"), t,
        lambda t=t: runner.load_downsampled(str(tmp_path / "pass_a_True"), t),
        cfg, cuda_device) for t in TYPES}
    a = runner.score_pass(second, sp.test, rankers, 128, overlap=True)
    b = runner.score_pass(second, sp.test, rankers, 128, overlap=False)
    for t in TYPES:
        assert np.array_equal(a[t][0], b[t][0]) and np.array_equal(a[t][1], b[t][1])
    assert json.loads(out[True][2]["passA-metrics.json"])["ceiling_total"] > 0
    assert os.path.exists(tmp_path / "kmeans-inertia.csv")


@pytest.mark.cuda
@pytest.mark.parametrize("group_context", [False, True])
def test_cuda_mlp_ranker_matches_cpu(cuda_device, group_context):
    """The MLP tower on the card against the CPU from the same weights, at
    RankerConfig() width (104 features, 256-128-64, [32, 128, 104]) and on
    a small case (32-16 hidden, [8, 64, 104]): scores within two bfloat16
    ulps (2^-6 relative + 1e-3) and three AdamW steps on the same batches
    under the same schedule with weights within 1e-4 (the output bias
    within the rates' sum: the loss does not see it)."""
    import copy

    import numpy as np

    from otto_tpu_torch.config import RankerConfig
    from otto_tpu_torch.engine.retrieval import FEATURE_NAMES
    from otto_tpu_torch.models import ranker

    F = len(FEATURE_NAMES)
    src = np.array([i for i, n in enumerate(FEATURE_NAMES) if n.startswith("src_")])
    devices = {"cpu": torch.device("cpu"), "card": cuda_device}
    rng = np.random.default_rng(7)
    for hidden, B, G in (((256, 128, 64), 32, 128), ((32, 16), 8, 64)):
        cfg = RankerConfig(hidden_dims=hidden)
        batches = mlp_batches(rng, B, G, F, src)
        mean, std = ranker.compute_norm_stats(batches[0][0].numpy().reshape(-1, F))
        tower = ranker.init_ranker(F, cfg, mean, std, src_idx=src if group_context else None)
        towers = {"cpu": tower, "card": copy.deepcopy(tower).to(cuda_device)}
        with torch.no_grad():
            s = {k: towers[k](batches[0][0].to(d)).cpu() for k, d in devices.items()}
        assert not bool(((s["card"] - s["cpu"]).abs()
                         > 2.0 ** -6 * s["cpu"].abs() + 1e-3).any())
        lr = ranker.lr_schedule(cfg, 6)
        for k, d in devices.items():
            opt = ranker.make_optimizer(towers[k], cfg)
            for i, batch in enumerate(batches):
                ranker.train_step(towers[k], opt, tuple(x.to(d) for x in batch), lr(i),
                                  cfg.sigma, cfg.eval_at)
        pairs = list(zip(towers["card"].weights(), towers["cpu"].weights()))
        for i, ((gw, gb), (w, b)) in enumerate(pairs):
            assert abs(gw - w).max() <= 1e-4
            assert abs(gb - b).max() <= (sum(lr(s) for s in range(3))
                                         if i == len(pairs) - 1 else 1e-4)


def mlp_batches(rng, B, G, F, src, n=3):
    """n seeded batches (feats [B, G, F] of mixed scales with src_* flags,
    labels, mask) shaped as pass A's padded groups: padding all zero."""
    import numpy as np

    out = []
    for _ in range(n):
        mask = rng.random((B, G)) < 0.7
        feats = (rng.standard_normal((B, G, F)) * rng.choice([1.0, 30.0, 1e4], F)
                 ).astype(np.float32)
        feats[..., src] = rng.random((B, G, len(src))) < 0.3
        feats[~mask] = 0.0
        labels = ((rng.random((B, G)) < 0.05) & mask).astype(np.float32)
        out.append(tuple(torch.from_numpy(a) for a in (feats, labels, mask)))
    return out


# K6 (HSTU's pointwise attention) at the serving shape and at the layout's
# edges: (sessions, largest history, most candidates, fixed L, fixed C).
# The kernel sums Q.K and A.V in another order than the twin and rounds A
# to bfloat16 after its own float32 sum, so an A near a bfloat16 rounding
# can round one step (2^-8) the other way; a term A v is at most about y's
# largest value and a few flips may meet in one y: K6_TOL of y's largest
# value (chip_smoke.py's bound; 1.5e-3 read at the serving shape)
K6_TOL = 5e-3
K6_CASES = {"serve": (2048, 30, 200, None, None), "L1": (300, 1, 40, 1, None),
            "C0": (64, 200, 0, None, 0), "C512": (16, 200, 512, None, 512),
            "one_session": (1, 200, 512, None, None)}


def k6_case(dev, S, Lmax, Cmax, Lfix, Cfix, H=4, seed=0):
    from otto_tpu_torch.ops.kernels import hstu_attention as k6

    g = torch.Generator(device=dev).manual_seed(seed)
    L = (torch.randint(0, Lmax + 1, (S,), generator=g, device=dev) if Lfix is None
         else torch.full((S,), Lfix, device=dev))
    C = (torch.randint(0, Cmax + 1, (S,), generator=g, device=dev) if Cfix is None
         else torch.full((S,), Cfix, device=dev))
    off = torch.zeros(S + 1, dtype=torch.int32, device=dev)
    off[1:] = torch.cumsum(L + C, 0).int()
    N = int(off[-1])
    # q, k and v as the ranker hands them over: views of one [N, 3 H 64] buffer
    buf = (torch.randn(N, 3 * H * 64, generator=g, device=dev) * 0.7).bfloat16()
    q, k, v = (buf[:, i * H * 64:(i + 1) * H * 64].view(N, H, 64) for i in range(3))
    ts = torch.randint(0, 2_400_000, (N,), generator=g, device=dev, dtype=torch.int32)
    w_pos = torch.randn(201, generator=g, device=dev)
    w_time = torch.randn(129, generator=g, device=dev)
    return q, k, v, off, L.int(), ts, w_pos, w_time, k6.time_bucket_thresholds(128, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K6_CASES))
def test_cuda_hstu_attention_matches_twin(cuda_device, case):
    from otto_tpu_torch.ops.kernels import hstu_attention as k6

    args = k6_case(cuda_device, *K6_CASES[case])
    k6.check_layout(args[3], args[4], args[0].shape[0], args[6].shape[0])
    before = k6.LAUNCHES.value
    got = k6.hstu_attention(*args, 200.0)
    assert k6.LAUNCHES.value == before + 1
    want = k6.hstu_attention_ref(*args, 200.0)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= K6_TOL * want.abs().max().clamp(min=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["cpu_tensor", "head_dim", "unaligned", "biases", "dtype"])
def test_cuda_hstu_attention_refuses(cuda_device, fault):
    from otto_tpu_torch.ops.kernels import hstu_attention as k6

    q, k, v, off, L, ts, w_pos, w_time, thr = k6_case(cuda_device, 4, 5, 6, None, None)
    if fault == "cpu_tensor":
        ts = ts.cpu()
    elif fault == "head_dim":
        q, k, v = (x[:, :, :32] for x in (q, k, v))
    elif fault == "unaligned":
        N = q.shape[0]
        buf = torch.zeros(N, 3 * 4 * 64 + 4, dtype=torch.bfloat16, device=cuda_device)
        q, k, v = (buf[:, 4 + i * 256:4 + (i + 1) * 256].view(N, 4, 64) for i in range(3))
    elif fault == "biases":
        w_pos = torch.zeros(k6.MAX_POS + 1, device=cuda_device)
    else:
        v = v.half()
    before = k6.LAUNCHES.value
    with pytest.raises((TypeError, ValueError)):
        k6.hstu_attention(q, k, v, off, L, ts, w_pos, w_time, thr, 200.0)
    assert k6.LAUNCHES.value == before


@pytest.mark.cuda
def test_cuda_hstu_ranker_matches_reference(cuda_device):
    """The HSTU ranker at the published widths through score_topk_multi on
    a 2,048-session batch: one K6 launch a block, the items read through
    K4, and every served list within 0.05 of the reference's order (a
    sample of sessions scored by tests/hstu_reference.py, float32, TF32
    off)."""
    import numpy as np

    from otto_tpu_torch.config import HSTUConfig
    from otto_tpu_torch.engine import rank
    from otto_tpu_torch.engine.retrieval import FEATURE_NAMES, RetrievedBatch
    from otto_tpu_torch.models import hstu
    from otto_tpu_torch.ops.kernels import hstu_attention as k6
    # by their own names: pytest puts this directory first on sys.path, and
    # another installed package may be called `tests`
    import hstu_reference as ref
    from test_torch_hstu import draw_batch, draw_params

    cfg = HSTUConfig()
    params = {k: v.to(cuda_device) for k, v in draw_params(cfg, 5000, seed=1).items()}
    r = hstu.HSTURanker(cfg, params, tuple(FEATURE_NAMES))
    aid, ts, typ, cand, feats = (x.to(cuda_device) for x in
                                 draw_batch(2048, seed=2, max_len=128, max_cand=300,
                                            c_slots=512, min_cand=100))
    aid = aid % 5000
    cand = torch.where(cand >= 0, cand % 5000, -1)
    b = RetrievedBatch(np.arange(2048), cand, feats, torch.zeros_like(cand),
                       history=(aid, ts, typ))
    k6_before, k4_before = k6.LAUNCHES.value, dma_gather.LAUNCHES.value
    tops = rank.score_topk_multi(b, [r, r, r])
    assert k6.LAUNCHES.value - k6_before == cfg.n_blocks
    assert dma_gather.LAUNCHES.value - k4_before == 1
    ref.no_tf32()
    worst = 0.0
    for s in range(0, 2048, 97):
        n = int((aid[s] >= 0).sum())
        ok = cand[s] >= 0
        want = ref.session_scores(params, cfg, aid[s, :n].cpu(), ts[s, :n].cpu(),
                                  typ[s, :n].cpu(), cand[s][ok].cpu(), feats[s][ok])
        by_aid = dict(zip(cand[s][ok].tolist(), want.T.tolist()))
        for t in range(3):
            got = tops[t, s][tops[t, s] >= 0]
            assert len(got) == min(20, int(ok.sum()))
            served = np.array([by_aid[a][t] for a in got.tolist()])
            best = np.sort(want[t].cpu().numpy())[::-1][:len(got)]
            worst = max(worst, float((best - served).max()))
    # the reference itself, computed on the card and on the CPU, differs by
    # up to 0.013 at these widths (eight blocks carry float32 summing orders
    # across bfloat16 roundings); the float8 control by 0.24-0.49
    assert worst <= 0.05


# K7: retrieve_batch on the card at production widths (five co-visitation
# tables of 10-20 neighbours, two kNN tables of 20, 128 popularity
# candidates of 50 clusters, 100-d embeddings, 32 kept aids, 512 slots),
# its Stage E inputs caught at `_stage_e` and run through the twin too
K7_AIDS = 1 << 14


def _k7_context(dev, seed, D=100):
    """Seeded tables: neighbour lists near each aid (so sources overlap),
    descending counts, partly empty rows, 5% of the aids without an
    embedding, popularity candidates beyond the sessions' aids."""
    from otto_tpu_torch.config import COVIS_FIRST_N
    from otto_tpu_torch.engine.covis import CoVisTables
    from otto_tpu_torch.engine.retrieval import RetrievalContext

    g = torch.Generator(device=dev).manual_seed(seed)
    A, i32 = K7_AIDS, torch.int32
    aid = torch.arange(A, device=dev)[:, None]

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev)

    def near(n):
        return ((aid + ri(-64, 65, (A, n))) % A).to(i32)

    covis = []
    for n in COVIS_FIRST_N.values():
        present = torch.arange(n, device=dev)[None, :] < ri(0, n + 1, (A, 1))
        count = torch.sort(ri(1, 1000, (A, n)), dim=1, descending=True).values
        count = torch.where(present, count, 0)
        covis.append(CoVisTables(
            neighbor=torch.where(present, near(n), -1), count=count.to(i32),
            count_pop=torch.where(present, ri(0, 10_000, (A, n)), 0).to(i32),
            perc_pop=torch.where(present, ri(0, 10_000, (A, n)), 0).to(i32),
            count_rel=(count * 100 // count[:, :1].clamp(min=1)).to(i32)))

    def knn():
        return near(20), torch.sort(torch.rand((A, 20), generator=g, device=dev), dim=1).values

    emb = torch.randn((A, D), generator=g, device=dev)
    emb[torch.rand(A, generator=g, device=dev) < 0.05] = 0.0
    return RetrievalContext(
        covis=tuple(covis), knn_all=knn(), knn_1_2=knn(),
        pop_cl50_cand=ri(0, A, (50, 128)).to(i32),
        pop_cl50_ranks=ri(1, 60, (50, 128, 6)).to(i32),
        pop_cl1_rank=ri(1, 999, (A, 6)).to(i32), aid_emb=emb)


def _k7_batch(dev, L, S, seed, D=100):
    """A padded [S, L] batch of bucket L: each session 1-L events from a
    few aids near its own centre, rising timestamps, mostly clicks; from
    S >= 16 on, the last S // 16 rows all padding (session -1, as a
    bucket's tail batch has them, with cluster 0 and a zero embedding)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = torch.randint(max(1, L // 4), L + 1, (S,), generator=g, device=dev)
    if S >= 16:
        n[-(S // 16):] = 0
    lane = torch.arange(L, device=dev)[None, :]
    real = lane < n[:, None]
    centre = torch.randint(0, K7_AIDS, (S, 1), generator=g, device=dev)
    pool = (centre + torch.randint(-40, 41, (S, L), generator=g, device=dev)) % K7_AIDS
    pick = torch.randint(0, max(2, L // 3), (S, L), generator=g, device=dev)
    aid = torch.where(real, pool.gather(1, pick), -1).int()
    ts = 1_600_000_000 + torch.cumsum(torch.randint(0, 900, (S, L), generator=g, device=dev), 1)
    ts = torch.where(real, ts, 0).int()
    typ = torch.multinomial(torch.tensor([0.8, 0.15, 0.05], device=dev), S * L,
                            replacement=True, generator=g).view(S, L)
    typ = torch.where(real, typ, 0).int()
    cluster = torch.randint(0, 50, (S,), generator=g, device=dev).int()
    semb = torch.randn((S, D), generator=g, device=dev)
    pad = n == 0
    return (aid, ts, typ), torch.where(pad, 0, cluster), torch.where(pad[:, None], 0.0, semb)


def _k7_run(dev, monkeypatch, L, S, keep_aids=32, max_candidates=512, seed=0, D=100,
            table=lambda emb: emb):
    """retrieve_batch on the card, and the twin on the Stage E inputs K7
    took; `table` may lay the item embeddings out anew. -> (K7's (cand,
    feats, ts_order), the twin's, Stage E's pk)."""
    from otto_tpu_torch.config import RetrievalConfig
    from otto_tpu_torch.engine import retrieval
    from otto_tpu_torch.ops.kernels import retrieval_features as k7

    caught = []
    stage_e = retrieval._stage_e

    def spy(*args):
        caught.append(args)
        return stage_e(*args)

    monkeypatch.setattr(retrieval, "_stage_e", spy)
    ctx = _k7_context(dev, seed, D)
    ctx = ctx._replace(aid_emb=table(ctx.aid_emb))
    padded, cluster, semb = _k7_batch(dev, L, S, seed + 1, D)
    cfg = RetrievalConfig()
    trim = torch.tensor([cfg.trim_max_at_order_1, cfg.trim_min,
                         (cfg.trim_max_at_order_1 - cfg.trim_min) / (cfg.trim_min_at_order - 1)],
                        device=dev)
    before = k7.LAUNCHES.value
    got = retrieval.retrieve_batch(padded, ctx, cluster, semb, trim, keep_aids, max_candidates)
    torch.cuda.synchronize()
    assert k7.LAUNCHES.value == before + 1 and len(caught) == 1
    twin = retrieval._features_program(*caught[0])
    torch.cuda.synchronize()
    return got, twin, caught[0][0]


def _k7_compare(got, twin):
    """cand and ts_order equal; every feature but the two similarity ones
    bit for bit (compared as words: -0.0 is not 0.0); those within 1e-5
    relative (and 1e-5 absolute near zero, as tests/test_torch_retrieval.py
    holds them)."""
    from otto_tpu_torch.engine.retrieval import FEATURE_INDEX, FEATURE_NAMES

    (cand, feats, ts), (cand_t, feats_t, ts_t) = got, twin
    assert torch.equal(cand, cand_t) and torch.equal(ts, ts_t)
    assert feats.shape == feats_t.shape
    sim = [FEATURE_INDEX["cos_sim_ses_aid"], FEATURE_INDEX["eucl_dist_ses_aid"]]
    words, words_t = feats.view(torch.int32), feats_t.view(torch.int32)
    off = [FEATURE_NAMES[j] for j in range(len(FEATURE_NAMES))
           if j not in sim and not torch.equal(words[..., j], words_t[..., j])]
    assert not off, f"features not bit-equal to the twin: {off}"
    assert torch.allclose(feats[..., sim], feats_t[..., sim], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 256, 2048])
@pytest.mark.parametrize("L", [8, 32, 128])
def test_cuda_retrieval_features_match_twin(cuda_device, monkeypatch, L, S):
    """K7 against its twin on the same transported lanes, at the pass-B
    cells' widths in three length buckets: among the lanes, aids without
    an embedding, popularity-only candidates (ts_order 999) and, from S =
    256 on, all-padding session rows."""
    from otto_tpu_torch.engine.retrieval import FEATURE_INDEX

    got, twin, pk = _k7_run(cuda_device, monkeypatch, L, S, seed=L + S)
    _k7_compare(got, twin)
    cand, feats, ts = got
    valid = cand >= 0
    assert pk.shape == (S, 512) and int(valid.sum()) > 100 * S
    assert bool((valid & (ts == 999)).any()), "no popularity-only candidate"
    if S > 1:
        no_emb = valid & (feats[..., FEATURE_INDEX["eucl_dist_ses_aid"]] == -1)
        assert bool(no_emb.any()), "no candidate without an embedding"
        pad_rows = (feats[..., FEATURE_INDEX["n_events_session"]] == 0).all(1)
        assert bool(pad_rows.any()), "no all-padding session row"


@pytest.mark.cuda
def test_cuda_retrieval_features_pad_past_the_lanes(cuda_device, monkeypatch):
    """A cap above the lanes kept (one kept aid: 121 + 128 lanes, cap
    512): K7 writes the padding slots (cand -1, ts_order 999, features 0)
    as the twin's F.pad does."""
    got, twin, pk = _k7_run(cuda_device, monkeypatch, 8, 256, keep_aids=1)
    _k7_compare(got, twin)
    C = pk.shape[1]
    cand, feats, ts = got
    assert C < 512
    assert bool((cand[:, C:] == -1).all()) and bool((ts[:, C:] == 999).all())
    assert bool((feats[:, C:].view(torch.int32) == 0).all())


def _unaligned(emb):
    """The same table at a 4-byte offset: its rows are not 16-byte aligned."""
    buf = torch.empty(emb.numel() + 1, dtype=emb.dtype, device=emb.device)
    out = buf[1:].view(emb.shape)
    out.copy_(emb)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["unaligned", "width_37"])
def test_cuda_retrieval_features_scalar_loads(cuda_device, monkeypatch, layout):
    """Item rows that 16-byte loads cannot read (a table at an odd word
    offset; D = 37) take the kernel's 4-byte loads into the same four
    strands: the unaligned table gives the aligned one's features bit for
    bit, and both layouts match the twin."""
    if layout == "unaligned":
        got, twin, _ = _k7_run(cuda_device, monkeypatch, 32, 256, seed=5, table=_unaligned)
        aligned, _, _ = _k7_run(cuda_device, monkeypatch, 32, 256, seed=5)
        for a, b in zip(got, aligned):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    else:
        got, twin, _ = _k7_run(cuda_device, monkeypatch, 32, 256, seed=6, D=37)
    _k7_compare(got, twin)
