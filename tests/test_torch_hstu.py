"""The HSTU ranker (otto_tpu_torch/models/hstu.py) and kernel K6's twin
(ops/kernels/hstu_attention.py) on the CPU, held to the plain reference
(tests/hstu_reference.py) at a small width: d 32, 2 blocks, 2 heads of 16,
seeded weights, sessions of 1-40 events (the history keeps its last 24)
with 0-30 valid candidates at scattered slots. The kernel itself runs
only on the card (tests/test_torch_cuda.py)."""
import math

import numpy as np
import pytest
import torch

from otto_tpu_torch.config import Config, HSTUConfig, TYPES
from otto_tpu_torch.engine import rank
from otto_tpu_torch.engine.retrieval import FEATURE_NAMES, RetrievedBatch
from otto_tpu_torch.models import hstu
from otto_tpu_torch.ops.kernels import hstu_attention as k6
import hstu_reference as ref
import torch_threads  # noqa: F401

CFG = HSTUConfig(d_model=32, n_heads=2, d_qk=16, d_v=16, n_blocks=2, max_seq_len=24)
N_AIDS = 500
NF = len(FEATURE_NAMES)
# The program and the reference round the same operands to bfloat16 and
# sum in float32, in shapes of their own (the reference per session, the
# program over the packed batch and K6's twin per row), so a BLAS may sum
# them in other orders (on this CPU they agree to the bit). A float32 ulp
# of difference moves a value across a bfloat16 rounding now and then;
# one such flip moves a score by ~1e-3 of its size at most. Scores spread
# by ~1: 2e-2 leaves room for a few flips and fails every planted fault
# (each moves scores by 0.25 or more; test_planted_faults_fail).
TOL = 2e-2


def draw_params(cfg=CFG, n_aids=N_AIDS, seed=0, bias_std=0.5):
    """Seeded float32 parameters at scales that keep every part of a block
    in play: unit-variance item rows, projections whose outputs stay near
    unit variance, position and time biases of bias_std."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in hstu.param_shapes(cfg, n_aids, NF).items():
        base = name.rsplit("_", 1)[0] if name[-1].isdigit() else name
        if base == "norm_mean":
            out[name] = torch.rand(shape, generator=g) * 3.0 - 0.5
        elif base == "norm_std":
            out[name] = torch.rand(shape, generator=g) * 1.5 + 0.5
        else:
            scale = {"item_emb": 1.0, "type_emb": 0.5, "w_pos": bias_std,
                     "w_time": bias_std, "b1": 0.1, "b2": 0.05, "head_b": 0.1}.get(base)
            out[name] = torch.randn(shape, generator=g) * (scale or 1.0 / math.sqrt(shape[0]))
    return out


def draw_batch(S, seed, max_len=40, max_cand=30, c_slots=48, min_cand=0):
    """A batch as retrieval hands it over: left-aligned [S, Lb] histories
    (aid -1 past each session's events, ts rising), [S, c_slots] candidates
    with -1 at empty slots scattered among them, [S, c_slots, F] features
    (heavy-tailed, zero at empty slots)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len + 1, S)
    Lb = int(lens.max())
    aid = np.full((S, Lb), -1, np.int32)
    ts = np.zeros((S, Lb), np.int32)
    typ = np.zeros((S, Lb), np.int32)
    cand = np.full((S, c_slots), -1, np.int32)
    for s in range(S):
        n = lens[s]
        aid[s, :n] = rng.integers(0, N_AIDS, n)
        gaps = np.exp(rng.uniform(0, np.log(2e5), n)).astype(np.int64)
        ts[s, :n] = 1_650_000_000 // 100 + np.cumsum(gaps) - gaps[0]
        typ[s, :n] = rng.choice(3, n, p=[0.8, 0.15, 0.05])
        c = rng.integers(min_cand, max_cand + 1)
        slots = np.sort(rng.choice(c_slots, c, replace=False))
        cand[s, slots] = rng.choice(N_AIDS, c, replace=False)
    feats = (rng.exponential(5.0, (S, c_slots, NF)) * rng.choice([-1, 1, 1, 1], (S, c_slots, NF)))
    feats = np.where(cand[:, :, None] >= 0, feats, 0.0).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (aid, ts, typ, cand, feats))


def ranker(params=None):
    return hstu.HSTURanker(CFG, params if params is not None else draw_params(),
                           tuple(FEATURE_NAMES))


def reference(params, batch, s, precision="full", fault=""):
    aid, ts, typ, cand, feats = batch
    n = int((aid[s] >= 0).sum())
    ok = cand[s] >= 0
    return ref.session_scores(params, CFG, aid[s, :n], ts[s, :n], typ[s, :n], cand[s][ok],
                              feats[s][ok], precision, fault)


def test_scores_match_reference():
    params = draw_params()
    batch = draw_batch(24, seed=1)
    got = ranker(params).encode(*batch)
    cand = batch[3]
    assert got.shape == (3, 24, cand.shape[1])
    assert torch.isinf(got[:, cand < 0]).all() and torch.isfinite(got[:, cand >= 0]).all()
    worst, spread = 0.0, []
    for s in range(24):
        want = reference(params, batch, s)
        spread.append(want.std().item() if want.shape[1] > 1 else 1.0)
        worst = max(worst, (got[:, s][:, cand[s] >= 0] - want).abs().max().item()
                    if want.numel() else 0.0)
    assert worst <= TOL
    # the scores spread enough for the tolerance to mean something
    assert np.median(spread) > 20 * TOL


@pytest.mark.parametrize("precision,fault", [("low", ""), ("full", "no_bias"),
                                             ("full", "softmax")])
def test_planted_faults_fail(precision, fault):
    """The reference one precision lower (float8 e4m3 operands), without its
    relative biases, or with softmax in place of SiLU / n_scale, lies
    beyond TOL of the true reference on this batch."""
    params = draw_params()
    batch = draw_batch(12, seed=2, min_cand=5)
    worst = max((reference(params, batch, s, precision, fault)
                 - reference(params, batch, s)).abs().max().item() for s in range(12))
    assert worst > 5 * TOL


def test_history_truncation_and_empty_candidates():
    """A history past max_seq_len keeps its last events; a session with no
    valid candidate scores nothing and leaves the others as they were."""
    params = draw_params()
    batch = draw_batch(6, seed=3, max_len=40)
    aid, ts, typ, cand, feats = batch
    assert int((aid >= 0).sum(1).max()) > CFG.max_seq_len
    cand2 = cand.clone()
    cand2[2] = -1
    r = ranker(params)
    a = r.encode(aid, ts, typ, cand, feats)
    b = r.encode(aid, ts, typ, cand2, feats)
    assert torch.isinf(b[:, 2]).all()
    keep = torch.tensor([0, 1, 3, 4, 5])
    torch.testing.assert_close(b[:, keep], a[:, keep], rtol=0, atol=TOL)
    for s in (0, 1):
        want = reference(params, batch, s)
        assert (a[:, s][:, cand[s] >= 0] - want).abs().max() <= TOL


@pytest.mark.parametrize("change", ["remove", "permute"])
def test_candidates_do_not_see_each_other(change):
    """M-FALCON: a candidate's scores stay when other candidates of its
    session are removed or the slots permuted (bit for bit: the twin
    computes each row alone, and the products' shapes stay)."""
    r = ranker()
    aid, ts, typ, cand, feats = draw_batch(8, seed=4, min_cand=10)
    base = r.encode(aid, ts, typ, cand, feats)
    g = torch.Generator().manual_seed(5)
    if change == "remove":
        cand2 = torch.where(torch.rand(cand.shape, generator=g) < 0.5, cand, -1)
        got = r.encode(aid, ts, typ, cand2, feats)
        ok = cand2 >= 0
        assert torch.equal(got[:, ok], base[:, ok])
        assert torch.isinf(got[:, (cand >= 0) & ~ok]).all()
    else:
        perm = torch.randperm(cand.shape[1], generator=g)
        got = r.encode(aid, ts, typ, cand[:, perm], feats[:, perm])
        assert torch.equal(got, base[:, :, perm])


def _widen(batch, width):
    """The batch's histories padded to `width` lanes."""
    aid, ts, typ, cand, feats = batch
    pad = width - aid.shape[1]
    f = torch.nn.functional.pad
    return f(aid, (0, pad), value=-1), f(ts, (0, pad)), f(typ, (0, pad)), cand, feats


def test_scores_do_not_depend_on_the_batch():
    """A session's scores are the same whichever batch serves it (other
    companions, a wider padded history, another row): bit for bit, as the
    twin computes each row alone and the CPU's products sum a row alike in
    any shape here."""
    r = ranker()
    a = draw_batch(10, seed=6, max_len=20)
    b = draw_batch(7, seed=7, max_len=40)
    got_a = r.encode(*a)
    a = _widen(a, b[0].shape[1])
    mixed = [y.clone() for y in b]
    for x, y in zip(a, mixed):
        y[5] = x[3]
    got_b = r.encode(*mixed)
    ok = a[3][3] >= 0
    assert torch.equal(got_b[:, 5][:, ok], got_a[:, 3][:, ok])


def _jagged(L, C, H=2, D=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    L, C = torch.tensor(L), torch.tensor(C)
    off = torch.zeros(len(L) + 1, dtype=torch.int32)
    off[1:] = torch.cumsum(L + C, 0)
    N = int(off[-1])
    qkv = (torch.randn(N, 3 * H * D, generator=g) * 0.8).bfloat16()
    q, k, v = (qkv[:, i * H * D:(i + 1) * H * D].view(N, H, D) for i in range(3))
    ts = torch.zeros(N, dtype=torch.int32)
    for s in range(len(L)):
        n = int(L[s])
        t = torch.cumsum(torch.randint(0, 100_000, (n,), generator=g), 0).int() if n else ts[:0]
        ts[off[s]:off[s] + n] = t
        ts[off[s] + n:off[s + 1]] = int(t[-1]) if n else 0
    w_pos = torch.randn(CFG.max_seq_len + 1, generator=g)
    w_time = torch.randn(CFG.n_time_buckets + 1, generator=g)
    return q, k, v, off, L.int(), ts, w_pos, w_time, k6.time_bucket_thresholds(128)


def padded_attention(q, k, v, off, L, ts, w_pos, w_time, n_scale):
    """Each session's full [T, T] scores, masked (the reference's block)."""
    y = torch.zeros(q.shape[0], q.shape[1], v.shape[2])
    for s in range(len(L)):
        a, b, n = int(off[s]), int(off[s + 1]), int(L[s])
        T = b - a
        pos = torch.cat([torch.arange(n), torch.full((T - n,), n)])
        mask = torch.zeros(T, T, dtype=torch.bool)
        mask[:n, :n] = torch.tril(torch.ones(n, n, dtype=torch.bool))
        mask[n:, :n] = True
        mask[n:, n:] = torch.eye(T - n, dtype=torch.bool)
        qs, ks, vs = (x[a:b].float().transpose(0, 1) for x in (q, k, v))
        sc = qs @ ks.transpose(1, 2)
        sc = sc + w_pos[(pos[:, None] - pos[None]).clamp(0)]
        sc = sc + w_time[ref.bucket(ts[a:b, None].long() - ts[None, a:b].long(), 128)]
        att = torch.where(mask, torch.nn.functional.silu(sc) / n_scale, 0.0)
        y[a:b] = (att.bfloat16().float() @ vs).transpose(0, 1)
    return y


@pytest.mark.parametrize("L,C", [([3, 1, 24, 7], [5, 30, 0, 12]), ([0, 2], [4, 3]),
                                 ([1] * 5, [1, 2, 3, 4, 5]), ([20], [0]), ([], [])])
def test_k6_twin_matches_padded_reference(L, C):
    args = _jagged(L, C)
    got = k6.hstu_attention(*args, 200.0)
    want = padded_attention(*args[:-1], 200.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_time_buckets_follow_the_formula():
    thr = k6.time_bucket_thresholds(128)
    xs = torch.cat([torch.arange(0, 5000), torch.tensor([2**31 - 1, 2**32, -7, -2**31]),
                    torch.unique(torch.logspace(0, 9.5, 4000).long())])
    xs = torch.cat([xs, xs[xs > 1] - 1, xs + 1])
    want = ref.bucket(xs, 128)
    assert torch.equal(k6.time_bucket(xs, thr), want)


def _bad(case):
    q, k, v, off, L, ts, w_pos, w_time, thr = _jagged([3, 4], [2, 5])
    if case == "dtype":
        q = q.float()
    elif case == "shape":
        v = v[:-1]
    elif case == "offsets_shape":
        off = off[:-1]
    elif case == "strides":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "row_stride":
        q = q.contiguous()
    elif case == "thr":
        thr = thr[:-1]
    elif case == "offsets_end":
        off = off.clone()
        off[-1] += 1
    elif case == "hist_above_tokens":
        L = L.clone()
        L[0] = 6
    elif case == "hist_above_positions":
        w_pos = w_pos[:3]
    return q, k, v, off, L, ts, w_pos, w_time, thr


@pytest.mark.parametrize("case", ["dtype", "shape", "offsets_shape", "strides", "row_stride",
                                  "thr", "offsets_end", "hist_above_tokens",
                                  "hist_above_positions"])
def test_k6_wrapper_refuses(case):
    with pytest.raises((TypeError, ValueError)):
        k6.hstu_attention(*_bad(case), 200.0)


def test_npz_round_trip(tmp_path):
    from otto_tpu_torch.pipeline import runner

    r = ranker()
    r.save(str(tmp_path / "ranker-hstu.npz"))
    back = hstu.HSTURanker.load(str(tmp_path / "ranker-hstu.npz"))
    assert back.cfg == CFG and back.feature_names == r.feature_names
    assert set(back.params) == set(r.params)
    for name, x in r.params.items():
        assert torch.equal(back.params[name], x), name
    batch = draw_batch(5, seed=8)
    assert torch.equal(back.encode(*batch), r.encode(*batch))
    loaded = runner.load_rankers(str(tmp_path), Config(ranker_backend="hstu"))
    assert list(loaded) == list(TYPES)
    assert all(x is loaded["clicks"] for x in loaded.values())
    with pytest.raises(ValueError):
        hstu.HSTURanker(HSTUConfig(d_model=32, n_heads=2, d_qk=16, d_v=16, n_blocks=3,
                                   max_seq_len=24), r.params, r.feature_names)


def test_training_is_refused(tmp_path):
    from otto_tpu_torch.data.schema import Events, Labels
    from otto_tpu_torch.pipeline import runner

    cfg = Config(ranker_backend="hstu")
    empty = Events(*(np.zeros(0, np.int32) for _ in range(4)))
    labels = Labels(*(np.zeros(0, np.int32) for _ in range(3)))
    with pytest.raises(ValueError, match="hstu.*does not train"):
        runner.run_streaming(empty, empty, labels, 10, str(tmp_path), "cpu", cfg)
    assert not any(tmp_path.iterdir())   # refused before the work dir was touched
    with pytest.raises(ValueError, match="does not train"):
        runner.train_ranker_cached(str(tmp_path), "clicks", lambda: None, cfg, "cpu")


def test_retrieved_batch_keeps_history_like_cand():
    aid, ts, typ, cand, feats = draw_batch(6, seed=9)
    keep = np.array([0, 2, 5])
    b = RetrievedBatch(session=np.array([10, 12, 15]), cand=cand, feats=feats[keep],
                       ts_order=torch.zeros_like(cand), keep=keep, history=(aid, ts, typ))
    for got, full in zip(b.history_device(), (aid, ts, typ)):
        assert torch.equal(got, full[torch.from_numpy(keep)])
    assert torch.equal(b.cand_device(), cand[torch.from_numpy(keep)])
    assert all(any(x is t for t in b.device_tensors()) for x in (aid, ts, typ))
    with pytest.raises(ValueError):
        RetrievedBatch(np.array([1]), cand[:1], feats[:1], cand[:1]).history_device()


def test_score_topk_multi_scores_once(monkeypatch):
    """score_topk_multi calls a multi-task ranker once a batch and takes
    each target's top-k of its scores."""
    r = ranker()
    aid, ts, typ, cand, feats = draw_batch(9, seed=10, min_cand=1)
    b = RetrievedBatch(np.arange(9), cand, feats, torch.zeros_like(cand),
                       history=(aid, ts, typ))
    calls = []
    orig = r.predict_scores_multi
    monkeypatch.setattr(r, "predict_scores_multi", lambda b_: calls.append(1) or orig(b_))
    got = rank.score_topk_multi(b, [r, r, r], top_k=20)
    assert len(calls) == 1 and got.shape == (3, 9, 20)
    scores = r.encode(aid, ts, typ, cand, feats)
    for t in range(3):
        want = rank._topk_program(scores[t], cand, 20)[1].numpy()
        np.testing.assert_array_equal(got[t], want)


def test_batch_runner_scores_once_a_batch(tmp_path, monkeypatch):
    """The batch runner's scoring (Pipeline._score) of the HSTU ranker that
    load_rankers reads for the three targets: one predict_scores_multi call
    a batch, and each target's lists as score_topk_multi gives them, in
    session order."""
    from otto_tpu_torch.pipeline import runner

    cfg = Config(ranker_backend="hstu")
    ranker().save(str(tmp_path / "ranker-hstu.npz"))
    rankers = runner.load_rankers(str(tmp_path), cfg)
    r = rankers["clicks"]
    batches = []
    for i, seed in enumerate((11, 12)):
        aid, ts, typ, cand, feats = draw_batch(7, seed=seed, min_cand=1)
        batches.append(RetrievedBatch(np.arange(7 * i, 7 * i + 7)[::-1].copy(), cand, feats,
                                      torch.zeros_like(cand), history=(aid, ts, typ)))
    want = [rank.score_topk_multi(b, [r, r, r], top_k=20) for b in batches]
    calls = []
    orig = r.predict_scores_multi
    monkeypatch.setattr(r, "predict_scores_multi", lambda b_: calls.append(1) or orig(b_))
    pipe = runner.Pipeline(cfg, str(tmp_path / "work"), N_AIDS, device="cpu")
    preds = pipe._score(batches, rankers)
    assert len(calls) == len(batches)
    for t, tname in enumerate(TYPES):
        sess, aids = preds[tname]
        np.testing.assert_array_equal(sess, np.arange(14))
        np.testing.assert_array_equal(aids, np.concatenate([m[t][::-1] for m in want]))
