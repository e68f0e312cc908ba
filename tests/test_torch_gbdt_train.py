"""GBDT lambdarank training: otto_tpu_torch against otto_tpu.models.gbdt.

Mirrors tests/test_gbdt.py on the port (binning, histogram oracle, lambda
signs, learning, save / load, periodic eval, early stopping) and holds it
to otto_tpu layer by layer:

- binning (edges, bins), ndcg@k and the session grouping: bit-equal;
- `_max_dcg`: within 4e-7 relative (a float32 sum in another order);
  `_lambda_grads_chunk`: within GRAD_RTOL (XLA's
  and torch's exp / log differ by an ulp, and the sums over a group run in
  another order);
- `_histograms` on the same inputs: within float32 ordering error of the
  exact sum (otto_tpu adds in float32 in the MXU's order, the port sums
  exactly and rounds once);
- `_build_tree` on the same gradients: equal splits, leaves within
  LEAF_TOL; each level's best split leads the runner-up by more than
  MARGIN_RTOL, so an equal tree is not an accident of a near tie;
- whole training with otto_tpu's threefry draws injected: equal split
  features and bins, leaves within TRAIN_LEAF_TOL, valid ndcg within
  NDCG_TOL;
- each package loads the other's `.npz`; predictions agree within
  PRED_RTOL.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.config import GBDTConfig as RefConfig
from otto_tpu.models import gbdt as ref
from otto_tpu.models import ranker as ref_ranker
from otto_tpu_torch.config import GBDTConfig
from otto_tpu_torch.models import gbdt as port
from otto_tpu_torch.models import ranker as port_ranker
import torch_threads  # noqa: F401

GRAD_RTOL = 1e-5      # relative to the group's largest |grad| / |hess|
# leaves from the same gradients; across whole trainings a gradient an ulp
# apart can round to another bfloat16 (a 2^-8 step of that row's term),
# and the scores carry it from tree to tree
LEAF_TOL = 1e-5
TRAIN_LEAF_TOL = 2e-4
PRED_RTOL = 1e-6      # a float32 sum over the trees, in another order
NDCG_TOL = 1e-4
MARGIN_RTOL = 1e-4    # a split must lead its runner-up by this share
NAMES = tuple(f"f{i}" for i in range(10))
CPU = torch.device("cpu")


def _synthetic_ranking(n_groups=300, g=16, f=10, seed=0):
    """Relevance depends on a nonlinear feature interaction (test_gbdt's)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_groups * g, f)).astype(np.float32)
    logits = (x[:, 0] > 0.3) * 2.0 + x[:, 1] * (x[:, 2] > 0) - 0.5 * x[:, 3]
    sess = np.repeat(np.arange(n_groups), g).astype(np.int64)
    y = np.zeros(n_groups * g, np.float32)
    for s in range(n_groups):
        rows = slice(s * g, (s + 1) * g)
        y[rows][np.argsort(-logits[rows])[:3]] = 1.0
    return x, y, sess


def _cfgs(**kw):
    """The same settings as otto_tpu's config and the port's."""
    return RefConfig(**kw), GBDTConfig(**kw)


def ref_draws(cfg, n_features, n_rows):
    """otto_tpu's per-tree draws (_train_core's threefry stream) as torch
    tensors, for the port's `draws` hook."""
    n_sub = max(1, int(round(cfg.colsample * n_features)))
    key0 = jax.random.PRNGKey(cfg.seed)

    def draws(t):
        k_feat, k_bag = jax.random.split(jax.random.fold_in(key0, t))
        feat_idx = np.asarray(jax.random.permutation(k_feat, n_features)[:n_sub])
        bag = np.asarray(jax.random.uniform(k_bag, (n_rows,)) < cfg.subsample)
        return torch.from_numpy(feat_idx.astype(np.int64)), torch.from_numpy(bag)

    return draws


def inject_ref_draws(monkeypatch):
    monkeypatch.setattr(port, "tree_draws",
                        lambda cfg, f, n, device: ref_draws(cfg, f, n))


# ---------------------------------------------------------------------------
# host layer: binning, grouping, ndcg
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sample", [1 << 20, 700])
def test_binning_matches_reference(sample):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3000, 6)).astype(np.float16)
    x[:, 3] = 7.0                                    # constant feature
    x[:, 4] = rng.integers(0, 3, 3000)               # duplicate quantiles
    got = port.compute_bin_edges(x, 16, sample=sample, seed=3)
    want = ref.compute_bin_edges(x, 16, sample=sample, seed=3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.bin_features(x, got), ref.bin_features(x, want))


def test_binning_roundtrip():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5000, 6)).astype(np.float32)
    x[:, 3] = 7.0
    edges = port.compute_bin_edges(x, n_bins=16)
    b = port.bin_features(x, edges)
    assert b.dtype == np.uint8 and b.max() < 16
    order = np.argsort(x[:, 0])
    assert (np.diff(b[order, 0].astype(int)) >= 0).all()
    assert len(np.unique(b[:, 3])) == 1
    # the device binning of prediction agrees with the host's
    dev = port._bin_program(torch.from_numpy(x), torch.from_numpy(edges))
    np.testing.assert_array_equal(dev.numpy(), b)


def test_group_pad_and_ndcg_match_reference():
    rng = np.random.default_rng(1)
    n = 900
    sess = rng.integers(0, 60, n)
    y = (rng.random(n) < 0.2).astype(np.int8)
    for feats in (rng.integers(0, 64, (n, 5)).astype(np.uint8),
                  rng.normal(size=(n, 5)).astype(np.float16)):
        for g in (8, 32):
            for a, b in zip(port_ranker._group_pad(feats, y, sess, g),
                            ref_ranker._group_pad(feats, y, sess, g)):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
    fg, lg, mg = port_ranker._group_pad(rng.normal(size=(n, 1)), y, sess, 32)
    scores = np.round(rng.normal(size=lg.shape), 1)        # ties
    for k in (5, 20, 64):
        assert port_ranker.ndcg_at_k(scores, lg, mg, k) == \
            ref_ranker.ndcg_at_k(scores, lg, mg, k)


def test_config_reads_both_packages():
    """Each field keeps its type: colsample 0.25 is not cast to 0."""
    got = GBDTConfig.from_dict(dataclasses.asdict(RefConfig()))
    assert got == GBDTConfig() and got.colsample == 0.25
    back = RefConfig(**dataclasses.asdict(GBDTConfig(colsample=0.5, lambda_norm=False)))
    assert back.colsample == 0.5 and back.lambda_norm is False


# ---------------------------------------------------------------------------
# device layers
# ---------------------------------------------------------------------------
def _groups(seed, C=48, G=24):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(C, G)).astype(np.float32)
    scores[: C // 4] = 0.0                               # the first tree: all ties
    scores[C // 4: C // 2] = np.round(scores[C // 4: C // 2])
    labels = (rng.random((C, G)) < 0.15).astype(np.float32)
    mask = rng.random((C, G)) < 0.8
    return scores, labels, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_lambda_grads_match_reference(seed):
    scores, labels, mask = _groups(seed)
    md_r = ref._max_dcg(jnp.asarray(labels), jnp.asarray(mask), 20)
    md_p = port._max_dcg(torch.from_numpy(labels), torch.from_numpy(mask), 20)
    # a float32 sum over the group, in XLA's order vs torch's
    np.testing.assert_allclose(md_p.numpy(), np.asarray(md_r), rtol=4e-7)
    for sigma, k, norm in ((1.0, 20, True), (1.0, 5, False), (2.0, 20, True)):
        want = ref._lambda_grads_chunk(jnp.asarray(scores), jnp.asarray(labels),
                                       jnp.asarray(mask), md_r, sigma, k, norm)
        got = port._lambda_grads_chunk(torch.from_numpy(scores), torch.from_numpy(labels),
                                       torch.from_numpy(mask), md_p, sigma, k, norm)
        for g, w in zip(got, want):
            w = np.asarray(w)
            scale = np.abs(w).max(axis=1, keepdims=True) + 1e-30
            assert (np.abs(g.numpy() - w) <= GRAD_RTOL * scale).all()


def test_lambda_grads_over_the_leading_positive_slots():
    """Positives first in each group (as _group_pad lays them out): the
    pairs over the first n_lead slots give the full [G, G] gradients."""
    scores, labels, mask = _groups(2)
    labels = -np.sort(-labels, axis=1)                   # positives first
    mask[:, :8] = True
    n_lead = int(np.nonzero((labels > 0).any(0))[0].max()) + 1
    assert n_lead < labels.shape[1]
    args = [torch.from_numpy(a) for a in (scores, labels, mask)]
    md = port._max_dcg(args[1], args[2], 20)
    full = port._lambda_grads_chunk(*args, md, 1.0, 20, True)
    lead = port._lambda_grads_chunk(*args, md, 1.0, 20, True, n_lead)
    for a, b in zip(lead, full):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_lambda_grads_push_positives_up():
    scores = torch.zeros((2, 4))
    labels = torch.tensor([[1, 0, 0, 0], [0, 0, 1, 0]], dtype=torch.float32)
    mask = torch.ones((2, 4), dtype=torch.bool)
    g, h = port._lambda_grads_chunk(scores, labels, mask,
                                    port._max_dcg(labels, mask, 20), 1.0, 20, True)
    assert g[0, 0] < 0 and g[1, 2] < 0 and (g[0, 1:] > 0).all()
    np.testing.assert_allclose(g.sum(1).numpy(), 0.0, atol=1e-6)
    assert (h >= 0).all()


def _hist_case(seed, n=3000, f=5, bins=16, w=4):
    rng = np.random.default_rng(seed)
    bn = rng.integers(0, bins, size=(n, f)).astype(np.uint8)
    bn[:, 0] = np.minimum(bn[:, 0], 1)                   # a hot bin
    node = rng.integers(0, w, size=n).astype(np.int32)
    gh3 = (rng.normal(size=(n, 3)) * np.exp(rng.normal(size=(n, 1)) * 3)).astype(np.float32)
    gh3[:, 2] = rng.random(n) < 0.6
    return bn, node, gh3, w, bins


def test_histogram_matches_bincount_oracle():
    bn, node, gh3, w, bins = _hist_case(1)
    h = port._histograms(torch.from_numpy(bn), torch.from_numpy(node),
                         torch.from_numpy(gh3), w, bins).numpy()
    # the exact sums of the bfloat16-rounded operands, in float64
    gh = torch.from_numpy(gh3).to(torch.bfloat16).double().numpy()
    ghc = ((node[:, None] == np.arange(w))[:, :, None] * gh[:, None, :]).reshape(len(bn), -1)
    for fi in range(bn.shape[1]):
        for di in range(w * 3):
            exact = np.bincount(bn[:, fi], weights=ghc[:, di], minlength=bins)
            # one float32 rounding of the exact sum (plus the fixed point's
            # 2^-30-relative floor, far below it here)
            np.testing.assert_allclose(h[fi, :, di], exact, rtol=2 ** -23, atol=1e-30)


@pytest.mark.parametrize("seed", [2, 3])
def test_histograms_match_reference(seed):
    bn, node, gh3, w, bins = _hist_case(seed)
    want = np.asarray(ref._histograms(jnp.asarray(bn), jnp.asarray(node),
                                      jnp.asarray(gh3), w, bins, 512))
    got = port._histograms(torch.from_numpy(bn), torch.from_numpy(node),
                           torch.from_numpy(gh3), w, bins).numpy()
    # float32 ordering error of otto_tpu's sum: n * 2^-24 of the summed |terms|
    gh = np.abs(torch.from_numpy(gh3).to(torch.bfloat16).double().numpy())
    ghc = ((node[:, None] == np.arange(w))[:, :, None] * gh[:, None, :]).reshape(len(bn), -1)
    mass = np.stack([np.stack([np.bincount(bn[:, fi], weights=ghc[:, d], minlength=bins)
                               for d in range(w * 3)], -1) for fi in range(bn.shape[1])])
    assert (np.abs(got - want) <= len(bn) * 2.0 ** -24 * mass).all()
    assert (got == want).mean() > 0.5


def test_histograms_do_not_depend_on_row_order():
    """Exact integer sums: any order of the rows gives the same bits."""
    bn, node, gh3, w, bins = _hist_case(4)
    perm = np.random.default_rng(0).permutation(len(bn))
    a = port._histograms(torch.from_numpy(bn), torch.from_numpy(node),
                         torch.from_numpy(gh3), w, bins)
    b = port._histograms(torch.from_numpy(bn[perm]), torch.from_numpy(node[perm]),
                         torch.from_numpy(gh3[perm]), w, bins)
    assert torch.equal(a, b)


def split_margins(bins_sub, grad, hess, cnt, cfg):
    """The port's level-wise growth of one tree, returning per level the
    smallest relative lead of a splitting node's best gain over its
    runner-up (another feature or bin)."""
    W = 1 << (cfg.max_depth - 1)
    node = torch.zeros(len(grad), dtype=torch.int64)
    out = []
    gh3 = torch.stack([grad, hess, cnt], -1)
    feat, thr, _, _, nodes = port._build_tree(bins_sub, grad, hess, cnt, cfg)
    for level in range(cfg.max_depth):
        H = port._histograms(bins_sub, node, gh3, W, cfg.n_bins).view(-1, cfg.n_bins, W, 3)
        cum = torch.cumsum(H, 1)
        tot = cum[:, -1:]
        g, h, c = cum.unbind(-1)
        gt, ht, ct = tot.unbind(-1)
        gain = (g * g / (h + 1e-9) + (gt - g) ** 2 / (ht - h + 1e-9) - gt * gt / (ht + 1e-9))
        ok = ((c >= cfg.min_child_samples) & (ct - c >= cfg.min_child_samples)
              & (h >= cfg.min_child_hessian) & (ht - h >= cfg.min_child_hessian))
        flat = torch.where(ok, gain, -torch.inf).reshape(-1, W)
        top2 = flat.topk(2, dim=0).values
        split = thr[level] < cfg.n_bins
        lead = ((top2[0] - top2[1]) / top2[0].abs().clamp(min=1e-30))[split]
        out.append(float(lead.min()) if len(lead) else np.inf)
        row_bin = bins_sub.gather(1, feat[level][node][:, None].long())[:, 0]
        node = node * 2 + (row_bin.long() >= thr[level][node]).long()
    return out


@pytest.mark.parametrize("seed,depth,l2", [(5, 3, 0.0), (6, 4, 0.5)])
def test_build_tree_matches_reference(seed, depth, l2):
    """The same (reference-computed) gradients -> the same tree."""
    rcfg, pcfg = _cfgs(max_depth=depth, n_bins=16, min_child_samples=5,
                       lambda_l2=l2, row_chunk=256)
    x, y, sess = _synthetic_ranking(n_groups=120, seed=seed)
    bins = ref.bin_features(x, ref.compute_bin_edges(x, 16))
    scores = np.random.default_rng(seed).normal(size=y.shape).astype(np.float32) * 0.3
    yg, mg = y.reshape(-1, 16), np.ones((120, 16), bool)
    md = ref._max_dcg(jnp.asarray(yg), jnp.asarray(mg), 20)
    grad, hess = (np.asarray(a).reshape(-1) for a in ref._lambda_grads_chunk(
        jnp.asarray(scores.reshape(-1, 16)), jnp.asarray(yg), jnp.asarray(mg), md,
        1.0, 20, True))
    cnt = (np.random.default_rng(seed + 1).random(len(y)) < 0.8).astype(np.float32)
    grad, hess = grad * cnt, hess * cnt
    sub = bins[:, [0, 1, 2, 3, 5, 7]]
    want = [np.asarray(a) for a in ref._build_tree(
        jnp.asarray(sub.astype(np.int32)), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(cnt), rcfg)]
    args = (torch.from_numpy(sub), torch.from_numpy(grad), torch.from_numpy(hess),
            torch.from_numpy(cnt))
    got = [a.numpy() for a in port._build_tree(*args, pcfg)]
    assert min(split_margins(*args, pcfg)) > MARGIN_RTOL
    np.testing.assert_array_equal(got[0], want[0])       # features
    np.testing.assert_array_equal(got[1], want[1])       # bins
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)   # gains
    np.testing.assert_allclose(got[3], want[3], atol=LEAF_TOL)
    np.testing.assert_array_equal(got[4], want[4])       # row -> leaf
    assert (got[1] < 16).sum() >= depth                  # real splits


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
TRAIN = dict(n_trees=20, max_depth=3, n_bins=16, colsample=0.5, subsample=0.8,
             min_child_samples=5, max_group=16, row_chunk=512, group_chunk=32,
             eval_every=5)


@pytest.fixture(scope="module")
def trained_pair():
    x, y, sess = _synthetic_ranking(n_groups=200)
    valid = _synthetic_ranking(n_groups=60, seed=5)
    rcfg, pcfg = _cfgs(**TRAIN)
    want = ref.train_gbdt_ranker(x, y, sess, NAMES, rcfg, valid=valid)
    with pytest.MonkeyPatch.context() as mp:
        inject_ref_draws(mp)
        got = port.train_gbdt_ranker(x, y, sess, NAMES, pcfg, valid=valid, device=CPU)
    return want, got, (x, y, sess), valid


def test_train_matches_reference_with_its_draws(trained_pair):
    want, got, _, _ = trained_pair
    np.testing.assert_array_equal(got.edges, want.edges)
    np.testing.assert_array_equal(got.gfeat, want.gfeat)
    np.testing.assert_array_equal(got.thr, want.thr)
    np.testing.assert_allclose(got.leaf, want.leaf, atol=TRAIN_LEAF_TOL)
    np.testing.assert_allclose(got.gains, want.gains, rtol=1e-3)
    assert [n for n, _ in got.eval_history] == [n for n, _ in want.eval_history] \
        == [5, 10, 15, 20]
    for (_, a), (_, b) in zip(got.eval_history, want.eval_history):
        assert abs(a - b) <= NDCG_TOL
    assert got.best_iter == want.best_iter
    assert abs(got.best_score - want.best_score) <= NDCG_TOL


def test_rankers_cross_load_with_equal_predictions(trained_pair, tmp_path):
    """Each package loads the other's `.npz` and predicts the same."""
    want, got, (x, _, _), _ = trained_pair
    got.save(str(tmp_path / "port.npz"))
    want.save(str(tmp_path / "ref.npz"))
    in_ref = ref.GBDTRanker.load(str(tmp_path / "port.npz"))
    in_port = port.GBDTRanker.load(str(tmp_path / "ref.npz"))
    assert in_ref.cfg == ref.GBDTRanker.load(str(tmp_path / "ref.npz")).cfg
    assert in_port.cfg == got.cfg and in_port.feature_names == NAMES
    np.testing.assert_allclose(in_ref.predict(x[:200]), got.predict(x[:200], CPU),
                               rtol=PRED_RTOL, atol=PRED_RTOL)
    np.testing.assert_allclose(in_port.predict(x[:200], CPU), want.predict(x[:200]),
                               rtol=PRED_RTOL, atol=PRED_RTOL)
    np.testing.assert_array_equal(in_ref.feature_importance(), got.feature_importance())


def test_gbdt_learns_ranking_and_beats_random():
    x, y, sess = _synthetic_ranking()
    cfg = GBDTConfig(n_trees=30, max_depth=3, n_bins=16, colsample=0.8, subsample=0.9,
                     min_child_samples=5, max_group=16, group_chunk=64)
    model = port.train_gbdt_ranker(x, y, sess, NAMES, cfg, device=CPU)
    yg = y.reshape(-1, 16)
    mask = np.ones_like(yg, bool)
    nd = port_ranker.ndcg_at_k(model.predict(x, CPU).reshape(-1, 16), yg, mask, 20)
    nd_rand = port_ranker.ndcg_at_k(
        np.random.default_rng(3).normal(size=yg.shape), yg, mask, 20)
    assert nd > 0.8 and nd > nd_rand + 0.3, (nd, nd_rand)
    assert model.best_iter == 30 and not model.eval_history


def test_gbdt_save_load_roundtrip(tmp_path):
    x, y, sess = _synthetic_ranking(n_groups=50)
    cfg = GBDTConfig(n_trees=5, max_depth=3, n_bins=16, colsample=0.8, subsample=1.0,
                     min_child_samples=5, max_group=16, group_chunk=32)
    model = port.train_gbdt_ranker(x, y, sess, NAMES, cfg, device=CPU)
    model.save(str(tmp_path / "gbdt.npz"))
    loaded = port.GBDTRanker.load(str(tmp_path / "gbdt.npz"))
    assert loaded.cfg == cfg
    np.testing.assert_array_equal(model.predict(x[:100], CPU), loaded.predict(x[:100], CPU))
    gain, split = model.feature_importance("gain"), model.feature_importance("split")
    assert gain.shape == (10,) and gain.sum() > 0
    assert np.all((gain > 0) == (split > 0))
    np.testing.assert_allclose(loaded.feature_importance("gain"), gain)


def test_gbdt_periodic_eval_and_best_iter(trained_pair):
    _, model, _, (xv, yv, _) = trained_pair
    hist = model.eval_history
    assert model.best_iter == max(hist, key=lambda e: e[1])[0]
    assert abs(model.best_score - max(n for _, n in hist)) < 1e-9
    # the accumulated eval scores against one prediction of every tree
    nd_full = port_ranker.ndcg_at_k(model.predict(xv, CPU).reshape(-1, 16),
                                    yv.reshape(-1, 16), np.ones((60, 16), bool), 20)
    assert abs(hist[-1][1] - nd_full) < 5e-3


def test_gbdt_early_stopping_truncates_to_best():
    x, y, sess = _synthetic_ranking(n_groups=100)
    valid = _synthetic_ranking(n_groups=30, seed=9)
    cfg = GBDTConfig(**{**TRAIN, "n_trees": 60, "early_stopping_rounds": 10,
                        "learning_rate": 0.8})
    model = port.train_gbdt_ranker(x, y, sess, NAMES, cfg, valid=valid, device=CPU)
    assert len(model.eval_history) < 12              # it stopped early
    assert len(model.leaf) == model.best_iter
    assert model.eval_history[-1][0] - model.best_iter >= 10
    assert np.isfinite(model.predict(x[:64], CPU)).all()


def test_training_is_deterministic_and_draws_from_its_seed():
    x, y, sess = _synthetic_ranking(n_groups=40)
    cfg = GBDTConfig(**{**TRAIN, "n_trees": 6})
    a, b = (port.train_gbdt_ranker(x, y, sess, NAMES, cfg, device=CPU) for _ in range(2))
    c = port.train_gbdt_ranker(x, y, sess, NAMES, dataclasses.replace(cfg, seed=7),
                               device=CPU)
    np.testing.assert_array_equal(a.leaf, b.leaf)
    np.testing.assert_array_equal(a.gfeat, b.gfeat)
    assert not np.array_equal(a.leaf, c.leaf)
    draws = port.tree_draws(cfg, 10, 100, CPU)
    f0, bag0 = draws(0)
    assert f0.shape == (5,) and len(set(f0.tolist())) == 5 and bag0.shape == (100,)
    assert torch.equal(draws(0)[1], bag0) and not torch.equal(draws(1)[1], bag0)
