"""The MLP LambdaRank ranker (otto_tpu_torch/models/ranker.py) against
otto_tpu's on the CPU: the same numpy inputs, and otto_tpu's initial
weights injected (its threefry draws cannot be repeated in torch).

Tolerances, and why:
- compute_norm_stats is numpy in both: bit-equal. _log_squash within 2
  float32 ulps: XLA's CPU log1p is its own rational approximation, not
  libm's, and differs from torch's by up to 2 ulps;
- scores within SCORE_RTOL relative + SCORE_ATOL (about two bfloat16
  ulps): the activations are rounded to bfloat16 before each product,
  and a float32 difference of an ulp at a rounding boundary moves an
  activation by a bfloat16 ulp;
- the loss and every weight gradient within GRAD_RTOL of the largest
  gradient (the last bias's gradient is a sum of terms that cancel, so
  its own scale is rounding noise);
- the schedule's rate at every step of 3-epoch runs within 1e-7
  relative;
- three AdamW steps: weights within 1e-4, but for the output bias. It
  shifts every score alike, so the loss does not see it: its gradient is
  rounding noise of either sign, which Adam turns into a step of about the
  learning rate either way. It is held within the sum of the rates.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from otto_tpu.config import RankerConfig as RefRankerConfig
from otto_tpu.models import ranker as ref
from otto_tpu_torch import convert
from otto_tpu_torch.config import RankerConfig
from otto_tpu_torch.models import ranker

from test_ranker import make_ranking_data
import torch_threads  # noqa: F401

SCORE_RTOL = 2.0 ** -6
SCORE_ATOL = 1e-3
GRAD_RTOL = 1e-4
LR_RTOL = 1e-7
STEP_ATOL = 1e-4


def case(seed, B=8, G=16, F=12, hidden=(32, 16), group_context=False):
    """Seeded groups [B, G, F] (features of mixed scales, masked slots,
    sparse positives) and otto_tpu's initial params for them."""
    rng = np.random.default_rng(seed)
    feats = (rng.standard_normal((B, G, F)) * rng.choice([1.0, 10.0, 1000.0], size=F)
             ).astype(np.float32)
    mask = rng.random((B, G)) < 0.8
    labels = ((rng.random((B, G)) < 0.15) & mask).astype(np.float32)
    src_idx = None
    if group_context:
        # two src_* flags, zero on padding as retrieval leaves them
        src_idx = np.array([0, 1], np.int32)
        feats[..., :2] = (rng.random((B, G, 2)) < 0.5) * mask[..., None]
    mean, std = ref.compute_norm_stats(feats.reshape(-1, F))
    params = ref.init_ranker(F, RefRankerConfig(hidden_dims=hidden), mean, std, seed=seed,
                             src_idx=src_idx)
    return feats, labels, mask, params


def assert_scores_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    bad = np.abs(got - want) > SCORE_RTOL * np.abs(want) + SCORE_ATOL
    assert not bad.any(), (got[bad][:5], want[bad][:5])


def test_norm_stats_and_log_squash():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4000, 6)) * 10.0 ** rng.integers(-6, 7, (4000, 6))
         ).astype(np.float32)
    x[:3, 0] = 0.0
    x[:, 5] = 7.0                                   # constant: std -> 1
    for got, want in zip(ranker.compute_norm_stats(x), ref.compute_norm_stats(x)):
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()
    got = ranker._log_squash(torch.from_numpy(x)).numpy()
    want = np.asarray(ref._log_squash(jnp.asarray(x)))
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulps.max() <= 2 and np.array_equal(np.sign(got), np.sign(want))
    # float16 rows (pass A's cache) are read as float32 first
    h = np.clip(x[:100], -6e4, 6e4).astype(np.float16)
    assert ranker.compute_norm_stats(h)[0].tobytes() == ref.compute_norm_stats(h)[0].tobytes()


@pytest.mark.parametrize("group_context", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_matches_reference(seed, group_context):
    feats, _, _, params = case(seed, group_context=group_context)
    want = ref.score(params, jnp.asarray(feats))
    tower = convert.ranker_from_numpy(params)
    assert (tower.src_idx is None) == (not group_context)
    with torch.no_grad():
        got = tower(torch.from_numpy(feats))
    assert got.dtype == torch.float32
    assert_scores_close(got.numpy(), want)
    # the listwise tower reads the group axis: a group's scores depend on
    # its other candidates
    if group_context:
        with torch.no_grad():
            alone = tower(torch.from_numpy(feats[:, :4]))
        assert not torch.allclose(alone, got[:, :4])


@pytest.mark.parametrize("group_context", [False, True])
@pytest.mark.parametrize("seed", [3, 4])
def test_loss_and_gradients_match_reference(seed, group_context):
    feats, labels, mask, params = case(seed, group_context=group_context)

    def loss_of(weights):
        return ref._lambdarank_loss(params._replace(weights=weights), jnp.asarray(feats),
                                    jnp.asarray(labels), jnp.asarray(mask), 1.0, 20)

    want_loss, want_g = jax.jit(jax.value_and_grad(loss_of))(params.weights)
    tower = convert.ranker_from_numpy(params)
    loss = ranker._lambdarank_loss(tower, torch.from_numpy(feats), torch.from_numpy(labels),
                                   torch.from_numpy(mask), 1.0, 20)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= GRAD_RTOL * abs(float(want_loss))
    want = [np.asarray(a) for wb in want_g for a in wb]
    got = [p.grad.numpy() for pair in zip(tower.w, tower.b) for p in pair]
    scale = max(np.abs(a).max() for a in want)
    assert scale > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= GRAD_RTOL * scale
    # the weights' gradients arrive rounded to bfloat16, as XLA's do
    for w in tower.w:
        assert torch.equal(w.grad, w.grad.to(torch.bfloat16).to(torch.float32))


def test_softplus_is_logaddexp():
    """jax.nn.softplus and its derivative, also past F.softplus's
    threshold of 20, where F.softplus returns x itself."""
    x = torch.tensor([-1e9, -80.0, -20.0, -1.0, 0.0, 0.5, 19.0, 21.0, 40.0, 1e9],
                     requires_grad=True)
    y = ranker._Softplus.apply(x)
    y.sum().backward()
    xn = x.detach().numpy()
    want, want_g = jax.vmap(jax.value_and_grad(jax.nn.softplus))(jnp.asarray(xn))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-6)


@pytest.mark.parametrize("n_groups,batch,lr", [(7, 64, 3e-3), (300, 64, 1e-3), (1000, 16, 1e-2)])
def test_schedule_matches_optax(n_groups, batch, lr):
    """The rate of every step of a 3-epoch run, as train_ranker sizes it."""
    B = min(batch, n_groups)
    total = max(1, n_groups // B) * 3
    cfg = dict(learning_rate=lr, epochs=3, batch_sessions=batch)
    rc = RefRankerConfig(**cfg)
    warmup = max(1, int(total * rc.warmup_frac))
    sched = jax.jit(optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=rc.learning_rate, warmup_steps=warmup,
        decay_steps=total, end_value=rc.learning_rate * rc.end_lr_frac))
    got = ranker.lr_schedule(RankerConfig(**cfg), total)
    assert got(0) == 0.0
    for step in range(total):
        want = float(sched(jnp.int32(step)))
        assert abs(got(step) - want) <= LR_RTOL * abs(want), (step, got(step), want)
    with pytest.raises(ValueError, match="no cosine decay"):
        ranker.lr_schedule(RankerConfig(**cfg), 1)


@pytest.mark.parametrize("group_context", [False, True])
def test_train_steps_match_reference(group_context):
    """Three AdamW steps from otto_tpu's initial params on the same batches
    under the same schedule: the first at rate 0 (moments only). The
    output bias is held within the rates' sum (module docstring)."""
    batches = [case(seed, group_context=group_context)[:3] for seed in (5, 6, 7)]
    params = case(5, group_context=group_context)[3]
    cfg = dict(hidden_dims=(32, 16), learning_rate=3e-3, weight_decay=1e-2)
    rc = RefRankerConfig(**cfg)
    total = 6
    sched = optax.warmup_cosine_decay_schedule(0.0, rc.learning_rate, 1, total,
                                               rc.learning_rate * rc.end_lr_frac)
    opt = optax.adamw(sched, weight_decay=rc.weight_decay)
    state = opt.init(params.weights)
    tower = convert.ranker_from_numpy(params)
    optimizer = ranker.make_optimizer(tower, RankerConfig(**cfg))
    lr = ranker.lr_schedule(RankerConfig(**cfg), total)
    key = jax.random.PRNGKey(0)
    for step, (f, y, m) in enumerate(batches):
        params, state, want_loss = ref.train_step(
            params, state, (jnp.asarray(f), jnp.asarray(y), jnp.asarray(m)), key, opt,
            rc.sigma, rc.eval_at, 0.0)
        loss = ranker.train_step(tower, optimizer, tuple(map(torch.from_numpy, (f, y, m))),
                                 lr(step), rc.sigma, rc.eval_at)
        assert abs(float(loss) - float(want_loss)) <= 1e-4 * abs(float(want_loss))
        layers = list(zip(tower.weights(), params.weights))
        for i, ((gw, gb), (w, b)) in enumerate(layers):
            np.testing.assert_allclose(gw, np.asarray(w), rtol=0, atol=STEP_ATOL)
            out_bias = i == len(layers) - 1
            atol = sum(lr(s) for s in range(step + 1)) if out_bias else STEP_ATOL
            np.testing.assert_allclose(gb, np.asarray(b), rtol=0, atol=atol)
    # the rate-0 first step left the weights where they started, then
    # they moved
    w0 = case(5, group_context=group_context)[3].weights[0][0]
    assert np.abs(tower.weights()[0][0] - np.asarray(w0)).max() > 10 * STEP_ATOL


def test_ranker_learns_signal():
    """test_ranker.py's case in both packages, each from its own start:
    valid ndcg@20 above 0.6 and within 0.03 of each other."""
    feats, labels, sessions = make_ranking_data()
    cfg = dict(hidden_dims=(32, 16), epochs=8, batch_sessions=64, max_group=20,
               learning_rate=1e-2)
    names = tuple(f"f{i}" for i in range(feats.shape[1]))
    want_r = ref.train_ranker(feats, labels, sessions, names, RefRankerConfig(**cfg))
    got_r = ranker.train_ranker(feats, labels, sessions, names, RankerConfig(**cfg), device="cpu")
    assert got_r.steps == 8 * (300 // 64) and len(got_r.history) == 8
    vf, vl, vs = make_ranking_data(seed=99)
    fg, lg, mg = ranker._group_pad(vf, vl, vs, 20)
    flat = fg.reshape(-1, vf.shape[1])
    want = ranker.ndcg_at_k(want_r.predict(flat).reshape(fg.shape[:2]), lg, mg, k=20)
    got = ranker.ndcg_at_k(got_r.predict(flat, "cpu").reshape(fg.shape[:2]), lg, mg, k=20)
    assert got > 0.6 and want > 0.6
    assert abs(got - want) <= 0.03, (got, want)


def test_training_keeps_the_best_epoch_and_stops_early():
    """With a valid set: ndcg after every epoch, the best epoch's weights
    restored, the run stopped early_stop_epochs after it."""
    feats, labels, sessions = make_ranking_data(120)
    vf, vl, vs = make_ranking_data(40, seed=5)
    cfg = RankerConfig(hidden_dims=(16,), epochs=12, batch_sessions=32, max_group=20,
                   learning_rate=3e-2, early_stop_epochs=2)
    names = tuple(f"f{i}" for i in range(feats.shape[1]))
    r = ranker.train_ranker(feats, labels, sessions, names, cfg, valid=(vf, vl, vs),
                            device="cpu")
    ndcgs = [h[2] for h in r.history]
    assert r.best_epoch == int(np.argmax(ndcgs))
    ran = len(r.history)
    assert ran == 12 or ran - 1 - r.best_epoch == 2
    fg, lg, mg = ranker._group_pad(vf, vl, vs, 20)
    got = ranker.ndcg_at_k(r.predict_grouped(fg, "cpu"), lg, mg, 20)
    assert got == pytest.approx(max(ndcgs), abs=1e-12)


@pytest.mark.parametrize("group_context", [False, True])
def test_save_load_both_ways(tmp_path, group_context):
    """Each package reads the other's `.npz` and scores within tolerance;
    the port's save and load round-trip bit for bit."""
    feats, labels, sessions = make_ranking_data(60)
    F = feats.shape[1]
    names = tuple(("src_a", "src_b") + tuple(f"f{i}" for i in range(2, F)))
    feats[:, :2] = feats[:, :2] > 0
    cfg = dict(hidden_dims=(16, 8), epochs=2, batch_sessions=16, max_group=20,
               group_context=group_context)
    want_r = ref.train_ranker(feats, labels, sessions, names, RefRankerConfig(**cfg))
    got_r = ranker.train_ranker(feats, labels, sessions, names, RankerConfig(**cfg), device="cpu")
    assert (got_r.tower.src_idx is not None) == group_context
    fg = ranker._group_pad(feats, labels, sessions, 20)[0][:12]

    def scores(r, pkg):
        if pkg == "ref":
            return r.predict_grouped(fg) if group_context else r.predict(
                fg.reshape(-1, F)).reshape(fg.shape[:2])
        return r.predict_grouped(fg, "cpu") if group_context else r.predict(
            fg.reshape(-1, F), "cpu").reshape(fg.shape[:2])

    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    want_r.save(ref_path)
    got_r.save(port_path)
    assert sorted(np.load(port_path).files) == sorted(np.load(ref_path).files)
    port_reads_ref = ranker.Ranker.load(ref_path, RankerConfig(**cfg))
    ref_reads_port = ref.Ranker.load(port_path, RefRankerConfig(**cfg))
    assert port_reads_ref.feature_names == ref_reads_port.feature_names == names
    assert_scores_close(scores(port_reads_ref, "port"), scores(want_r, "ref"))
    assert_scores_close(scores(ref_reads_port, "ref"), scores(got_r, "port"))
    again = ranker.Ranker.load(port_path, RankerConfig(**cfg))
    np.testing.assert_array_equal(scores(again, "port"), scores(got_r, "port"))
    if group_context:
        with pytest.raises(ValueError, match="listwise"):
            again.predict(fg.reshape(-1, F), "cpu")


def test_init_is_seeded_he_normal():
    cfg = RankerConfig(hidden_dims=(64, 32))
    a = ranker.init_ranker(20, cfg, np.zeros(20), np.ones(20))
    b = ranker.init_ranker(20, cfg, np.zeros(20), np.ones(20))
    c = ranker.init_ranker(20, cfg, np.zeros(20), np.ones(20), seed=7,
                           src_idx=np.array([0, 3]))
    assert [tuple(w.shape) for w in a.w] == [(20, 64), (64, 32), (32, 1)]
    assert [tuple(w.shape) for w in c.w][0] == (60, 64)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.w[0], c.w[0][:20])
    assert all(not bool(v.any()) for v in a.b)
    assert float(a.w[0].std()) == pytest.approx(np.sqrt(2 / 20), rel=0.1)


@pytest.mark.parametrize("group_context", [False, True])
def test_serving_top_k_matches_reference(group_context):
    """engine/rank.py's score_and_topk and score_topk_multi with an MLP
    ranker on a retrieval batch [S, C, F] (the listwise tower takes C as
    its group axis) against otto_tpu's score and top-k: top scores within
    the score tolerance, and each aid the reference's at its rank but at
    a near tie (the reference scores it within the tolerance there)."""
    from otto_tpu.engine import rank as ref_rank
    from otto_tpu_torch.engine import rank as port_rank
    from otto_tpu_torch.engine.retrieval import FEATURE_NAMES, RetrievedBatch

    F, S, C = len(FEATURE_NAMES), 12, 48
    rng = np.random.default_rng(11)
    cand = np.stack([rng.permutation(1000)[:C] for _ in range(S)]).astype(np.int32)
    cand[rng.random((S, C)) < 0.3] = -1
    feats = (rng.standard_normal((S, C, F)) * 3.0).astype(np.float32)
    src = np.array([i for i, n in enumerate(FEATURE_NAMES) if n.startswith("src_")], np.int32)
    feats[..., src] = rng.random((S, C, len(src))) < 0.3
    feats[cand < 0] = 0.0                     # retrieval's null fill of padding
    mean, std = ref.compute_norm_stats(feats.reshape(-1, F))
    params = ref.init_ranker(F, RefRankerConfig(hidden_dims=(32, 16)), mean, std, seed=3,
                             src_idx=src if group_context else None)
    port = ranker.Ranker(RankerConfig(), convert.ranker_from_numpy(params), FEATURE_NAMES)
    b = RetrievedBatch(np.arange(S), torch.from_numpy(cand), torch.from_numpy(feats),
                       torch.zeros((S, C), dtype=torch.int32))
    sess, got_a, got_s = port_rank.score_and_topk([b], port)
    multi = port_rank.score_topk_multi(b, [port, port])
    assert multi.shape == (2, S, 20)
    assert np.array_equal(multi[0], got_a) and np.array_equal(multi[1], got_a)
    ref_scores = np.asarray(ref.score(params, jnp.asarray(feats)))
    want_s, want_a = (np.asarray(a) for a in ref_rank._topk_program(
        jnp.asarray(ref_scores), jnp.asarray(cand), 20))
    fin = np.isfinite(want_s)
    assert np.array_equal(np.isfinite(got_s), fin)
    assert_scores_close(got_s[fin], want_s[fin])
    assert np.array_equal(got_a < 0, want_a < 0)
    for r, j in zip(*np.nonzero(got_a != want_a)):
        picked = ref_scores[r, list(cand[r]).index(got_a[r, j])]
        assert abs(picked - want_s[r, j]) <= 2 * (SCORE_RTOL * abs(want_s[r, j]) + SCORE_ATOL)
    assert (got_a == want_a).mean() > 0.9
