"""The CUDA kernels against their plain twins, on the card.

Marked `cuda`: each test skips where no CUDA device is present (decided in
the fixture, at run time). This file imports no jax, so it runs on a
machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which configures jax.)
"""
import pytest
import torch

from otto_tpu_torch.ops.kernels import dma_gather, gather, mips, segscan


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize(
    "B,S,P,W", [(3, 9, 300, 300), (1, 1000, 104, 150), (2, 7, 4000, 4000),
                (2, 5, 15000, 3)],
)
def test_cuda_gather_matches_twin(cuda_device, dtype, B, S, P, W):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    vals = torch.randint(-1000, 1000, (B, S, P), generator=g,
                         device=cuda_device).to(dtype)
    idx = torch.randint(0, P, (S, W), generator=g, device=cuda_device,
                        dtype=torch.int32)
    before = gather.launches
    got = gather.gather_rows(vals, idx, check=True)
    torch.cuda.synchronize()
    assert gather.launches == before + 1
    assert torch.equal(got, gather.gather_rows_ref(vals, idx))


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
    before = segscan.launches
    got = segscan.segmented_scan(vals, first, red)
    torch.cuda.synchronize()
    assert segscan.launches == before + 1
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
    before = mips.launches
    got = mips.mips_topk(q, c, k, metric)
    torch.cuda.synchronize()
    assert mips.launches == before + 1
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
    before = dma_gather.launches
    got = dma_gather.gather_rows_hbm(table, ids)
    torch.cuda.synchronize()
    assert dma_gather.launches == before + (1 if N else 0)
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
    from otto_tpu_torch.data.synthetic import SyntheticSpec, generate
    from otto_tpu_torch.engine import baseline
    from otto_tpu_torch.engine.covis import CoVisCounter
    from otto_tpu_torch.engine.popularity import compute_popularity

    ev = generate(SyntheticSpec(n_sessions=800, n_aids=3000, max_len=64, seed=3), cuda_device)
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
        out.append((meta.cpu(), bits.cpu(), ev.hits.cpu(), ev.hist.cpu(), rows))
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
    from otto_tpu_torch.data.synthetic import SyntheticSpec, generate
    from otto_tpu_torch.models import word2vec as w2v

    cpu = torch.device("cpu")
    ev = generate(SyntheticSpec(n_sessions=3000, n_aids=5000, max_len=64, mean_len=12,
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
