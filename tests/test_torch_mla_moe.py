"""The MLA + MoE ranker (otto_tpu_torch/models/mla_moe.py), kernel K9's twin
(ops/kernels/grouped_gemm.py) and K6's softmax form's twin
(ops/kernels/softmax_attention.py) on the CPU, held to the plain reference
(benchmark/reference/mla_moe.py) at a small width: d 64, 2 heads, 8
routed experts (top 2) and 1 shared, 1 dense and 2 MoE layers, tokens in
chunks of 100 (so a batch spans several), seeded weights drawn as the
benchmark draws them, sessions of 1-40 events (the history keeps its last
24) with 0-30 valid candidates at scattered slots. The kernels themselves
run only on the card (tests/test_torch_cuda.py)."""
import dataclasses
import math
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import control_mla_moe, serve_mla_moe
from benchmark.reference import mla_moe as ref
from otto_tpu_torch.config import Config, MLAMoEConfig, TYPES
from otto_tpu_torch.engine import rank
from otto_tpu_torch.engine.retrieval import FEATURE_NAMES, RetrievedBatch
from otto_tpu_torch.models import mla_moe
from otto_tpu_torch.ops.kernels import grouped_gemm as k9
from otto_tpu_torch.ops.kernels import softmax_attention as k6s
from test_torch_hstu import draw_batch
import torch_threads  # noqa: F401

CFG = MLAMoEConfig(hidden_size=64, num_hidden_layers=3, num_attention_heads=2, kv_lora_rank=32,
                   qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                   intermediate_size=96, moe_intermediate_size=32, n_routed_experts=8,
                   num_experts_per_tok=2, n_shared_experts=1, max_seq_len=24)
N_AIDS = 500
NF = len(FEATURE_NAMES)
# The program and the reference round the same operands to bfloat16 and
# sum in float32, in shapes of their own (the reference per session and
# expert by expert, the program over the packed batch in chunks), so a
# BLAS may sum them in other orders (on this CPU they agree to the bit). A
# float32 ulp of difference moves a value across a bfloat16 rounding now
# and then, ~1e-3 of a score at most, and may flip a near-tied expert
# choice, ~1e-2. Scores spread by ~0.9: 3e-2 leaves room for that and fails
# every planted fault (each moves scores by 0.4 or more;
# test_planted_faults_fail).
TOL = 3e-2
# the router's weights are one float32 product, a sigmoid and a division:
# the program's and the reference's agree to float32 rounding
ROUTER_TOL = 1e-6


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    monkeypatch.setattr(mla_moe, "CHUNK_TOKENS", 100)


def draw_params(cfg=CFG, seed=0):
    """The benchmark's weights."""
    return serve_mla_moe.mla_moe_weights(dataclasses.asdict(cfg), N_AIDS, NF, seed, "cpu")


def ranker(params=None, cfg=CFG):
    return mla_moe.MLAMoERanker(cfg, params if params is not None else draw_params(cfg),
                                tuple(FEATURE_NAMES))


def session_rows(batch, sessions):
    aid, _, typ, cand, feats = batch
    rows = []
    for s in sessions:
        n = int((aid[s] >= 0).sum())
        ok = cand[s] >= 0
        rows.append((aid[s, :n].numpy(), typ[s, :n].numpy(), cand[s][ok].numpy(), feats[s][ok]))
    return rows


def reference(params, batch, sessions, precision="full", fault="", routing=None, given=None):
    """The reference's scores in one stream; `routing` a dict gets its
    Routing under "s"; `given` the expert sets it takes."""
    return ref.forward(params, types.SimpleNamespace(**dataclasses.asdict(CFG)),
                       session_rows(batch, sessions), [("s", precision, given)], fault,
                       routing)["s"]


def program_sets(r, batch, route=None):
    """The program's expert sets on a batch (one [tokens, k] a MoE layer)
    and its scores, with `route` in place of its router where given."""
    log = []
    orig = mla_moe.route
    inner = route or orig
    try:
        mla_moe.route = lambda *a, **k: (lambda o: (log.append(o[0]), o)[1])(inner(*a, **k))
        scores = r.encode(*batch)
    finally:
        mla_moe.route = orig
    n_moe = CFG.num_hidden_layers - CFG.first_k_dense_replace
    return list(torch.cat(log).view(n_moe, -1, CFG.num_experts_per_tok)), scores


def worst_gap(got, want, cand):
    return max((got[:, s][:, cand[s] >= 0] - w).abs().max().item()
               for s, w in enumerate(want) if w.numel())


def test_scores_match_reference():
    params = draw_params()
    batch = draw_batch(24, seed=1)
    got = ranker(params).encode(*batch)
    cand = batch[3]
    assert got.shape == (3, 24, cand.shape[1])
    assert torch.isinf(got[:, cand < 0]).all() and torch.isfinite(got[:, cand >= 0]).all()
    want = reference(params, batch, range(24))
    worst = max((got[:, s][:, cand[s] >= 0] - w).abs().max().item()
                for s, w in enumerate(want) if w.numel())
    assert worst <= TOL
    # the scores spread enough for the tolerance to mean something
    assert np.median([w.std().item() for w in want if w.shape[1] > 1]) > 20 * TOL


@pytest.mark.parametrize("fault", ["low", "bias_in_weights", "no_shared", "rope_pairs"])
def test_planted_faults_fail(fault):
    """The reference one precision lower (float8 e4m3 operands), with the
    correction bias in the routing weights, without the shared expert, or
    with RoPE's pairs taken as (i, i + rope / 2), lies beyond TOL of the
    true reference."""
    params = draw_params()
    batch = draw_batch(12, seed=2, min_cand=5)
    want = reference(params, batch, range(12))
    got = reference(params, batch, range(12), *(("low", "") if fault == "low"
                                                else ("full", fault)))
    assert max((g - w).abs().max().item() for g, w in zip(got, want)) > 5 * TOL


def test_router_semantics():
    """Sigmoid scores of a float32 product; the bias chooses the experts
    but is not in their weights; the chosen scores are normalised, then
    times routed_scaling_factor; the reference's router agrees to float32
    rounding, and its TF32 fault does not."""
    g = torch.Generator().manual_seed(0)
    h = torch.randn(200, 64, generator=g)
    wr = torch.randn(64, 8, generator=g) / 8
    bias = torch.randn(8, generator=g) * 0.2
    idx, w = mla_moe.route(h, wr, bias, 2, 2.446)
    assert idx.dtype == torch.int64 and w.dtype == torch.float32
    s = torch.sigmoid(h.double() @ wr.double()).float()
    torch.testing.assert_close(w, 2.446 * s.gather(1, idx) / s.gather(1, idx).sum(1, keepdim=True))
    torch.testing.assert_close(w.sum(1), torch.full((200,), 2.446))
    plain = torch.topk(s, 2, dim=1).indices.sort(1).values
    assert (plain != idx.sort(1).values).any(1).float().mean() > 0.1   # the bias chose
    assert torch.equal(mla_moe.route(h, wr, bias * 0, 2, 2.446)[0].sort(1).values, plain)
    ns = types.SimpleNamespace(**dataclasses.asdict(CFG))
    r_idx, r_w, margin = ref.route(h, wr, bias, ns)
    assert (margin == 0).all()
    assert torch.equal(r_idx.sort(1).values, idx.sort(1).values)
    assert (r_w.sort(1).values - w.sort(1).values).abs().max() <= ROUTER_TOL
    _, tf_w, _ = ref.route(h, wr, bias, ns, "tf32")
    assert (tf_w.sort(1).values - w.sort(1).values).abs().max() > 100 * ROUTER_TOL
    _, bias_w, _ = ref.route(h, wr, bias, ns, "bias_in_weights")
    assert (bias_w.sort(1).values - w.sort(1).values).abs().max() > 100 * ROUTER_TOL


def test_rope_pairs_raw_dims_2i_2i_plus_1():
    """Raw dims (2i, 2i + 1) turn together at theta^(-2i / rope), and land
    at (i, i + rope / 2), as DeepSeek-V3's apply_rotary_pos_emb places
    them; the reference's rotation is the same and its fault is not."""
    dim, pos = CFG.qk_rope_head_dim, 7
    cos, sin = mla_moe.rope_tables(CFG, "cpu")
    for i in range(dim // 2):
        x = torch.zeros(1, dim)
        x[0, 2 * i] = 1.0
        out = mla_moe.rope(x, cos[pos:pos + 1], sin[pos:pos + 1])[0]
        ang = pos * CFG.rope_theta ** (-2 * i / dim)
        want = torch.zeros(dim)
        want[i], want[i + dim // 2] = math.cos(ang), math.sin(ang)
        torch.testing.assert_close(out, want, atol=1e-6, rtol=0)
    x = torch.randn(5, 3, dim)
    p = torch.tensor([0, 3, 7, 11, 24])
    port = mla_moe.rope(x, cos[p][:, None], sin[p][:, None])
    assert torch.equal(ref.rotate(x, p, CFG.rope_theta), port)
    assert (ref.rotate(x, p, CFG.rope_theta, "rope_pairs") - port).abs().max() > 0.1


def test_candidates_do_not_see_each_other():
    """Changing, dropping or reordering other candidates leaves a
    candidate's scores as they were."""
    r = ranker()
    aid, ts, typ, cand, feats = draw_batch(6, seed=3, min_cand=4)
    a = r.encode(aid, ts, typ, cand, feats)
    cand2, feats2 = cand.clone(), feats.clone()
    for s in range(6):
        slots = torch.nonzero(cand[s] >= 0).flatten()
        cand2[s, slots[0]] = (cand[s, slots[0]] + 17) % N_AIDS
        feats2[s, slots[0]] = feats[s, slots[1]]
        cand2[s, slots[1]] = -1
    b = r.encode(aid, ts, typ, cand2, feats2)
    for s in range(6):
        rest = torch.nonzero(cand[s] >= 0).flatten()[2:]
        torch.testing.assert_close(b[:, s, rest], a[:, s, rest], rtol=0, atol=1e-5)


def test_scores_do_not_depend_on_the_batch():
    """A session scored alone or in a batch, near a chunk edge or not."""
    r = ranker()
    batch = draw_batch(10, seed=4)
    full = r.encode(*batch)
    for s in (0, 6, 9):
        alone = r.encode(*(x[s:s + 1] for x in batch))
        torch.testing.assert_close(alone[:, 0], full[:, s], rtol=0, atol=1e-5)


def test_history_truncation_and_empty_batch():
    r = ranker()
    aid, ts, typ, cand, feats = draw_batch(5, seed=5, max_len=40)
    assert int((aid >= 0).sum(1).max()) > CFG.max_seq_len
    params = r.params
    got = r.encode(aid, ts, typ, cand, feats)
    want = reference(params, (aid, ts, typ, cand, feats), range(5))
    assert max((got[:, s][:, cand[s] >= 0] - w).abs().max().item()
               for s, w in enumerate(want) if w.numel()) <= TOL
    none = r.encode(aid, ts, typ, torch.full_like(cand, -1), feats)
    assert torch.isinf(none).all()


def loop_experts(a, w, offsets, rows, gate_up, out_rows, row_scale, n_out):
    """K9's function written as a loop over rows (the test's own)."""
    E, N_w, _ = w.shape
    N = N_w // 2 if gate_up else N_w
    out = torch.zeros((n_out, N))
    for e in range(E):
        for r in range(int(offsets[e]), int(offsets[e + 1])):
            x = a[rows[r] if rows is not None else r].float()
            y = w[e].float() @ x
            if gate_up:
                out[r] = (F.silu(y[:N]) * y[N:]).bfloat16().float()
            else:
                out[out_rows[r] if out_rows is not None else r] = \
                    y * (row_scale[r] if row_scale is not None else 1.0)
    return out


@pytest.mark.parametrize("counts", [[0, 5, 0, 3, 1, 0], [0, 0, 9, 0, 0, 0], [2, 2, 2, 2, 2, 2]])
@pytest.mark.parametrize("gate_up", [True, False])
def test_k9_twin_matches_a_loop(counts, gate_up):
    """Empty experts, one expert holding every row, every expert alike."""
    g = torch.Generator().manual_seed(sum(counts))
    E, K, N = len(counts), 16, 8
    offsets = torch.tensor([0] + np.cumsum(counts).tolist(), dtype=torch.int32)
    R = int(offsets[-1])
    w = torch.randn(E, 2 * N if gate_up else N, K, generator=g).bfloat16()
    if gate_up:
        a = torch.randn(4, K, generator=g).bfloat16()
        rows = torch.randint(0, 4, (R,), generator=g, dtype=torch.int32)
        got = k9.grouped_gemm(a, w, offsets, rows=rows, gate_up=True)
        assert got.dtype == torch.bfloat16 and got.shape == (R, N)
        want = loop_experts(a, w, offsets, rows, True, None, None, R)
    else:
        a = torch.randn(R, K, generator=g).bfloat16()
        out_rows = torch.randperm(R + 3, generator=g)[:R].int()
        scale = torch.rand(R, generator=g)
        out = torch.full((R + 3, N), 7.0)
        got = k9.grouped_gemm(a, w, offsets, out_rows=out_rows, row_scale=scale, out=out)
        assert got is out
        want = loop_experts(a, w, offsets, None, False, out_rows, scale, R + 3)
        untouched = torch.ones(R + 3, dtype=torch.bool)
        untouched[out_rows.long()] = False
        assert (got[untouched] == 7.0).all()
        got = got[~untouched]
        want = want[~untouched]
    torch.testing.assert_close(got.float(), want, rtol=1e-5, atol=1e-5)


def test_k9_gate_up_writes_the_given_out():
    """A view of a larger buffer (the encoder's whole-chunk rows) takes the
    gate_up form's output; nothing past the view is touched."""
    g = torch.Generator().manual_seed(3)
    offsets = torch.tensor([0, 3, 3, 7], dtype=torch.int32)
    w = torch.randn(3, 16, 16, generator=g).bfloat16()
    a = torch.randn(5, 16, generator=g).bfloat16()
    rows = torch.randint(0, 5, (7,), generator=g, dtype=torch.int32)
    buf = torch.full((10, 8), 7.0, dtype=torch.bfloat16)
    got = k9.grouped_gemm(a, w, offsets, rows=rows, gate_up=True, out=buf[:7])
    assert got.data_ptr() == buf.data_ptr() and (buf[7:] == 7.0).all()
    assert torch.equal(got, k9.grouped_gemm(a, w, offsets, rows=rows, gate_up=True))


def test_softmax_writes_the_given_out():
    g = torch.Generator().manual_seed(4)
    q, k = (torch.randn(9, 2, 12, generator=g).bfloat16() for _ in range(2))
    v = torch.randn(9, 2, 8, generator=g).bfloat16()
    off = torch.tensor([0, 4, 9], dtype=torch.int32)
    L_ = torch.tensor([2, 3], dtype=torch.int32)
    buf = torch.full((12, 2, 8), 7.0)
    got = k6s.softmax_attention(q, k, v, off, L_, 0.3, out=buf[:9])
    assert got.data_ptr() == buf.data_ptr() and (buf[9:] == 7.0).all()
    assert torch.equal(got, k6s.softmax_attention(q, k, v, off, L_, 0.3))
    with pytest.raises(ValueError):
        k6s.softmax_attention(q, k, v, off, L_, 0.3, out=buf[:8])


@pytest.mark.parametrize("case", ["dtype", "weights", "offsets", "rows", "gate_up_out",
                                  "out_rows_alone", "segments"])
def test_k9_wrapper_refuses(case):
    a = torch.zeros(6, 16, dtype=torch.bfloat16)
    w = torch.zeros(2, 8, 16, dtype=torch.bfloat16)
    off = torch.tensor([0, 2, 6], dtype=torch.int32)
    kw = {"dtype": dict(a=a.float(), w=w, offsets=off),
          "weights": dict(a=a, w=w[:, :, :8], offsets=off),
          "offsets": dict(a=a, w=w, offsets=off[:2]),
          "rows": dict(a=a, w=w, offsets=off, rows=torch.zeros(6, dtype=torch.int64)),
          "gate_up_out": dict(a=a, w=w, offsets=off, gate_up=True, out=torch.zeros(6, 4)),
          "out_rows_alone": dict(a=a, w=w, offsets=off, out_rows=torch.zeros(6, dtype=torch.int32)),
          "segments": dict(a=a, w=w, offsets=torch.tensor([0, 4, 2], dtype=torch.int32))}[case]
    with pytest.raises((TypeError, ValueError)):
        k9.grouped_gemm(**kw)


def padded_softmax(q, k, v, L, C, scale):
    """One session's [T, T] masked softmax attention (the test's own)."""
    T = L + C
    mask = torch.zeros((T, T), dtype=torch.bool)
    mask[:L, :L] = torch.tril(torch.ones((L, L), dtype=torch.bool))
    mask[L:, :L] = True
    mask[L:, L:] = torch.eye(C, dtype=torch.bool)
    s = torch.einsum("thd,uhd->htu", q.float(), k.float()) * scale
    a = torch.softmax(s.masked_fill(~mask, -torch.inf), -1).bfloat16().float()
    return torch.einsum("htu,uhd->thd", a, v.float())


@pytest.mark.parametrize("lens", [[(3, 4), (0, 2), (5, 0), (1, 1)], [(0, 3)], [(7, 0), (2, 9)]])
def test_softmax_twin_matches_padded_softmax(lens):
    g = torch.Generator().manual_seed(len(lens))
    H, Dqk, Dv = 2, 12, 8
    T = sum(L + C for L, C in lens)
    q, k = (torch.randn(T, H, Dqk, generator=g).bfloat16() for _ in range(2))
    v = torch.randn(T, H, Dv, generator=g).bfloat16()
    off = torch.tensor([0] + np.cumsum([L + C for L, C in lens]).tolist(), dtype=torch.int32)
    L_ = torch.tensor([L for L, _ in lens], dtype=torch.int32)
    got = k6s.softmax_attention(q, k, v, off, L_, 0.3)
    for s, (L, C) in enumerate(lens):
        o = int(off[s])
        want = padded_softmax(q[o:o + L + C], k[o:o + L + C], v[o:o + L + C], L, C, 0.3)
        torch.testing.assert_close(got[o:o + L + C], want, rtol=1e-5, atol=1e-5)


def test_npz_round_trip(tmp_path):
    """save writes one .npz (bfloat16 arrays as their words); load reads
    shapes from the headers and each array as scoring moves it; the
    scores are the same, also through load_rankers; a ranker of another
    depth refuses the parameters."""
    from otto_tpu_torch.pipeline import runner

    r = ranker()
    path = str(tmp_path / "ranker-mla_moe.npz")
    r.save(path)
    back = mla_moe.MLAMoERanker.load(path)
    assert back.cfg == CFG and back.feature_names == r.feature_names
    assert set(back.params) == set(r.params)
    for name, x in r.params.items():
        y = back.params[name].read()
        assert y.dtype == x.dtype and torch.equal(y, x), name
    batch = draw_batch(5, seed=8)
    assert torch.equal(back.encode(*batch), r.encode(*batch))
    loaded = runner.load_rankers(str(tmp_path), Config(ranker_backend="mla_moe"))
    assert list(loaded) == list(TYPES)
    assert all(x is loaded["clicks"] for x in loaded.values())
    with pytest.raises(ValueError):
        mla_moe.MLAMoERanker(dataclasses.replace(CFG, num_hidden_layers=4), r.params,
                             r.feature_names)


def test_training_is_refused(tmp_path):
    from otto_tpu_torch.data.schema import Events, Labels
    from otto_tpu_torch.pipeline import cli, runner

    cfg = Config(ranker_backend="mla_moe")
    empty = Events(*(np.zeros(0, np.int32) for _ in range(4)))
    labels = Labels(*(np.zeros(0, np.int32) for _ in range(3)))
    with pytest.raises(ValueError, match="mla_moe.*does not train"):
        runner.run_streaming(empty, empty, labels, 10, str(tmp_path), "cpu", cfg)
    assert not any(tmp_path.iterdir())   # refused before the work dir was touched
    with pytest.raises(ValueError, match="does not train"):
        runner.train_ranker_cached(str(tmp_path), "clicks", lambda: None, cfg, "cpu")
    # the CLI's choices and help, and the refusal, come from the backend table
    assert "mla_moe" in runner.backends_help().split("served from a saved file:")[1]
    with pytest.raises(SystemExit):
        cli.main(["run-synthetic", "--ranker-backend", "no_such_backend"])


def test_score_topk_multi_scores_once(monkeypatch):
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
        assert np.array_equal(got[t], want)


def test_counters_and_routing_record():
    """The encoder counts its tokens and routed rows; the expert sets a run
    records are the reference's own top-k on the same sessions."""
    r = ranker()
    batch = draw_batch(8, seed=11)
    for c in (mla_moe.TOKENS, mla_moe.MOE_ROWS, mla_moe.MOE_MAX_ROWS):
        c.reset()
    prog, _ = program_sets(r, batch)
    aid, _, _, cand, _ = batch
    n = int(((aid >= 0).sum(1).clamp(max=CFG.max_seq_len) + (cand >= 0).sum(1)).sum())
    n_moe = CFG.num_hidden_layers - CFG.first_k_dense_replace
    assert mla_moe.TOKENS.value == n
    assert mla_moe.MOE_ROWS.value == n_moe * n * CFG.num_experts_per_tok
    assert isinstance(mla_moe.MOE_MAX_ROWS.value, int)
    assert mla_moe.MOE_ROWS.value / CFG.n_routed_experts <= mla_moe.MOE_MAX_ROWS.value
    routing = {}
    reference(r.params, batch, range(8), routing=routing, given=prog)
    assert routing["s"].flip_share() == 0.0 and routing["s"].max_margin() == 0.0
    own = {}
    reference(r.params, batch, range(8), routing=own)
    for a, b in zip(prog, own["s"].sets):
        assert torch.equal(a.sort(1).values, b.sort(1).values)


def test_given_sets_are_weighed_and_judged():
    """A stream on given expert sets weighs them by its own scores: its own
    sets (in any order) give its own scores and margin 0; sets chosen
    without the correction bias give other scores, flips and margins as
    wide as the bias moves them; a stream may take another's sets."""
    r = ranker()
    batch = draw_batch(8, seed=12, min_cand=3)
    params = r.params
    own = {}
    want = reference(params, batch, range(8), routing=own)
    shuffled = [s.flip(1) for s in own["s"].sets]
    same = {}
    got = reference(params, batch, range(8), routing=same, given=shuffled)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
    assert same["s"].flip_share() == 0.0 and same["s"].max_margin() == 0.0
    no_bias = lambda *a: control_mla_moe.fault_route("bias_not_chosen")(*a)  # noqa: E731
    wrong, _ = program_sets(r, batch, no_bias)
    moved = {}
    got = reference(params, batch, range(8), routing=moved, given=wrong)
    assert max((g - w).abs().max().item() for g, w in zip(got, want)) > 5 * TOL
    assert moved["s"].flip_share() > 5.0
    assert moved["s"].max_margin() > 0.01
    rows = session_rows(batch, range(8))
    ns = types.SimpleNamespace(**dataclasses.asdict(CFG))
    two = {}
    out = ref.forward(params, ns, rows, ["full", ("b", "full", "full")], routing=two)
    for g, w in zip(out["b"], want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
    assert two["b"].max_margin() == 0.0


@pytest.mark.parametrize("fault", control_mla_moe.FAULTS)
def test_planted_routed_faults_fail(fault):
    """The program with a routed fault planted in its router (the routed
    experts dropped, the bias in the weights, the weights not normalised
    or not scaled, the experts chosen without the bias) lies beyond TOL
    of the reference on its own sets, or its sets lie far from the
    reference's top-k."""
    r = ranker()
    batch = draw_batch(24, seed=13, min_cand=5)
    sets, got = program_sets(r, batch, control_mla_moe.fault_route(fault))
    routing = {}
    want = reference(r.params, batch, range(24), routing=routing, given=sets)
    gap = worst_gap(got, want, batch[3])
    if fault == "bias_not_chosen":
        assert routing["s"].max_margin() > 0.01
    else:   # its first MoE layer chose as the reference does; its scores moved
        assert routing["s"].margins[0].max() == 0.0
        # the bias (N(0, 0.03^2)) moves each weight ~6% of a chosen score
        # (~0.5), and the scores ~0.05; the other faults move them 0.4 or more
        assert gap > (TOL if fault == "bias_in_weights" else 5 * TOL)
