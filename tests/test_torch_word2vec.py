"""SGNS word2vec training: the port against otto_tpu/models/word2vec.py.

Held bit-equal: the host preparation (flat corpus, position map, alias
and CDF tables, keep probabilities, the negative-sharing choice) and the
numpy pairs of the host sampler.

One step of each path (block, pair, chunk, host) runs on both packages
from the same start (a seeded state with every table and accumulator
non-zero) and otto_tpu's threefry draws, fed through the port's draws
hook; the sampled indices are then equal and the updated tables and
accumulators agree within STEP_RTOL / STEP_ATOL: both sides sum in float32
but in other orders (XLA's fused reductions vs torch's, sigmoid as
1 / (1 + exp(-x)) vs torch's, rsqrt).

Whole trainings use each package's own draws (threefry vs a
torch.Generator), so they are held by the reference's quality test on the
40-topic fixture (intra > inter + 0.3, tests/test_word2vec.py) and by their
topic separation, within SEPARATION_TOL of otto_tpu's on the same corpus.

Plain SGD (block steps) and the fused-accumulator chunk step are held the
same way: one step from otto_tpu's state and draws, the SGD rate of every
step bit-equal to otto_tpu's, and the fused trainings bit-equal to the
port's own chunk trainings on the same draws.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.config import Word2VecConfig as RefConfig
from otto_tpu.data.synthetic import SyntheticSpec, generate
from otto_tpu.models import word2vec as ref
from otto_tpu_torch.config import Word2VecConfig
from otto_tpu_torch.data.schema import Events
from otto_tpu_torch.models import word2vec as w2v
from otto_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from test_word2vec import simple_events

STEP_RTOL = 1e-5
STEP_ATOL = 1e-6
SEPARATION_TOL = 0.1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These trainings run thousands of small ops: one intra-op thread is
    faster than a pool of them, and leaves the cores to the other test
    workers. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_events(ev):
    return Events(ev.session, ev.aid, ev.ts, ev.type)


@pytest.fixture(scope="module")
def corpus():
    """otto_tpu's synthetic sessions: skewed counts, all three types."""
    ev = generate(SyntheticSpec(n_sessions=400, n_aids=300, mean_len=10, seed=5))
    return ev, port_events(ev)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# host preparation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("types,min_count", [((0, 1, 2), 1), ((0, 1, 2), 3), ((1, 2), 1)])
def test_host_preparation_bit_equal(corpus, types, min_count):
    ref_ev, ev = corpus
    vocab = w2v.build_vocab(ev, types, min_count, 300)
    ref_vocab = ref.build_vocab(ref_ev, types, min_count, 300)
    words, cum = w2v.flat_corpus(ev, vocab, types)
    want_w, want_c = ref.flat_corpus(ref_ev, ref_vocab, types)
    for got, want in ((words, want_w), (cum, want_c),
                      (w2v.pack_position_info(cum), ref.pack_position_info(want_c)),
                      (w2v.make_neg_cdf(vocab.counts, 0.75), ref.make_neg_cdf(ref_vocab.counts)),
                      *zip(w2v.make_alias(vocab.counts, 0.6), ref.make_alias(ref_vocab.counts, 0.6))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert len(cum) > 10 and (np.diff(cum) >= 2).all()
    for t in (0.0, 1e-3, 1e-2):
        # otto_tpu computes this inline in train_word2vec_device (:937-945)
        freq = ref_vocab.counts / max(ref_vocab.counts.sum(), 1)
        want = (np.minimum(1.0, np.sqrt(t / np.maximum(freq, 1e-12)) + t / np.maximum(freq, 1e-12))
                .astype(np.float32) if t > 0 else np.ones(ref_vocab.size, np.float32))
        got = w2v.keep_probs(vocab.counts, t)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_pack_position_info_oracle():
    packed = w2v.pack_position_info(np.array([0, 3, 5, 9], np.int32))
    assert (packed >> 16).tolist() == [0, 1, 2, 0, 1, 0, 1, 2, 3]
    assert (packed & 0xFFFF).tolist() == [3, 3, 3, 2, 2, 4, 4, 4, 4]


@pytest.mark.parametrize("V,positions,sharing,want", [
    (99_999, 4_999_999, "auto", "pair"), (100_000, 10, "auto", "chunk"),
    (10, 5_000_000, "auto", "chunk"), (10**6, 10**8, "pair", "pair"),
    (10, 10, "chunk", "chunk")])
def test_negative_mode(V, positions, sharing, want):
    """train_word2vec_device's rule (:960-969)."""
    assert w2v.negative_mode(Word2VecConfig(neg_sharing=sharing), V, positions) == want


@pytest.mark.parametrize("subsample_t", [0.0, 1e-2])
def test_skipgram_pairs_bit_equal(corpus, subsample_t):
    ref_ev, ev = corpus
    vocab = w2v.build_vocab(ev, (0, 1, 2), 1, 300)
    got = w2v.skipgram_pairs(ev, vocab, (0, 1, 2), 4, subsample_t, np.random.default_rng(3))
    want = ref.skipgram_pairs(ref_ev, ref.build_vocab(ref_ev, (0, 1, 2), 1, 300), (0, 1, 2),
                              4, subsample_t, np.random.default_rng(3))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and len(g) > 1000
        np.testing.assert_array_equal(g, w)


def test_alias_draws_match_unigram_distribution():
    counts = np.array([100, 50, 10, 5, 1, 1, 1, 1], np.int64)
    prob, alias = w2v.make_alias(counts, 0.75)
    d = w2v.block_draws(torch.Generator().manual_seed(0), 1, 1, 1, 1, len(counts), 200_000)
    j = d["neg_j"]
    draws = torch.where(d["neg_u"] < torch.from_numpy(prob)[j], j, torch.from_numpy(alias).long()[j])
    want = counts.astype(np.float64) ** 0.75
    np.testing.assert_allclose(np.bincount(draws.numpy(), minlength=8) / len(draws),
                               want / want.sum(), atol=0.01)


# ---------------------------------------------------------------------------
# one step of each path, from otto_tpu's draws
# ---------------------------------------------------------------------------
@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def ref_block_draws(key, C, k, window, N, V, n_pool):
    """The draws of otto_tpu's _sample_center_block and _alias_draw."""
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    ka, kb = jax.random.split(k6)
    r = jax.random
    return {"flat": r.randint(k1, (C,), 0, N), "b": r.randint(k2, (C,), 1, window + 1),
            "off": r.randint(k3, (C, k), 0, window), "sign": r.bernoulli(k4, 0.5, (C, k)),
            "keep": r.uniform(k5, (C, k + 1)), "neg_j": r.randint(ka, (n_pool,), 0, V),
            "neg_u": r.uniform(kb, (n_pool,))}


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def ref_pair_draws(key, B, window, neg_shape):
    """The draws of otto_tpu's _sample_pair_batch and _sgns_step_body."""
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    r = jax.random
    return {"pos_u": r.uniform(k1, (B,)), "b": r.randint(k2, (B,), 1, window + 1),
            "off": r.randint(k3, (B,), 1, window + 1), "sign": r.bernoulli(k4, 0.5, (B,)),
            "keep": r.uniform(k5, (B, 2)), "neg_u": r.uniform(k6, neg_shape)}


def to_port(draws, device="cpu"):
    """threefry draws -> the port's draws (integers as int64)."""
    out = {}
    for k, v in draws.items():
        t = torch.from_numpy(np.array(v))
        out[k] = (t.long() if not t.is_floating_point() and t.dtype != torch.bool else t).to(device)
    return out


def epoch_draws(seed, epochs, chunk, one):
    """otto_tpu's key chain (:1072-1083, fold_in per dispatch and per
    step) as the port's draws(epoch, step) hook; one(key) -> draws."""
    key, subs = jax.random.PRNGKey(seed), []
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        subs.append(sub)

    def draws(epoch, step):
        c, i = divmod(step, chunk)
        return to_port(one(jax.random.fold_in(jax.random.fold_in(subs[epoch], c), i)))

    return draws


def seeded_state(V, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(V, D)).astype(np.float32) * 0.3,
            rng.normal(size=(V, D)).astype(np.float32) * 0.3,
            rng.uniform(0.01, 2.0, V).astype(np.float32),
            rng.uniform(0.01, 2.0, V).astype(np.float32))


def assert_step_close(port_params, ref_params, port_loss, ref_loss, touched_min):
    for name, g, w in zip(w2v.SGNSParams._fields, port_params, ref_params):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=name)
    start = seeded_state(*np.asarray(ref_params.emb_in).shape)
    moved = (np.asarray(ref_params.emb_out) != start[1]).any(1).sum()
    assert moved >= touched_min, moved
    np.testing.assert_allclose(float(port_loss), float(ref_loss), rtol=STEP_RTOL)


@pytest.fixture(scope="module")
def step_inputs(corpus):
    """A small vocabulary with heavy duplicates in a batch, subsampling on."""
    ref_ev, ev = corpus
    vocab = w2v.build_vocab(ev, (0, 1, 2), 2, 300)
    words, cum = w2v.flat_corpus(ev, vocab, (0, 1, 2))
    return vocab, words, cum, w2v.keep_probs(vocab.counts, 1e-2)


def block_step_both(step_inputs, lr, optimizer):
    """One block step of each package from seeded_state and otto_tpu's
    draws. -> (port params, port loss, otto_tpu params, otto_tpu loss)."""
    vocab, words, cum, keep = step_inputs
    V, D, C, k, window, n_negs = vocab.size, 16, 512, 4, 5, 4
    Ks = n_negs * 8
    n_pool = C // (256 // k) * Ks
    prob, alias = w2v.make_alias(vocab.counts, 0.75)
    pos_info = w2v.pack_position_info(cum)
    state = seeded_state(V, D)
    key = jax.random.PRNGKey(7)
    want, want_loss = jax.jit(ref._sgns_step_body_block, static_argnums=(7, 8, 9, 10, 12))(
        ref.SGNSParams(*map(jnp.asarray, state)), jnp.asarray(words), jnp.asarray(pos_info),
        jnp.asarray(prob), jnp.asarray(alias), jnp.asarray(keep), jnp.float32(lr),
        C, k, window, n_negs, key, optimizer)
    p = w2v.SGNSParams(*(torch.from_numpy(s.copy()) for s in state))
    loss = w2v._block_step(
        p, _t(words).long(), _t(pos_info).long(), _t(prob), _t(alias).long(), _t(keep), lr,
        k, n_negs, to_port(ref_block_draws(key, C, k, window, len(words), V, n_pool)),
        optimizer)
    return p, loss, want, want_loss


def test_block_step_matches_reference(step_inputs):
    p, loss, want, want_loss = block_step_both(step_inputs, 0.25, "adagrad")
    assert_step_close(p, want, loss, want_loss, touched_min=step_inputs[0].size // 2)


def test_sgd_block_step_matches_reference(step_inputs):
    """Plain SGD (otto_tpu :407-418): -lr * g added to the rows, the
    accumulators left as they were."""
    p, loss, want, want_loss = block_step_both(step_inputs, 0.025, "sgd")
    assert_step_close(p, want, loss, want_loss, touched_min=step_inputs[0].size // 2)
    start = seeded_state(step_inputs[0].size, 16)
    for got, s0 in zip(p[2:], start[2:]):
        np.testing.assert_array_equal(got.numpy(), s0)


def test_fused_step_matches_reference(step_inputs):
    """One fused chunk step from otto_tpu's fuse_params state and its
    draws against otto_tpu's sgns_epoch_device_fused of one step."""
    vocab, words, cum, keep = step_inputs
    V, D, B, window, n_negs, lr = vocab.size, 16, 1024, 5, 4, 0.25
    cdf = w2v.make_neg_cdf(vocab.counts)
    state = seeded_state(V, D)
    key = jax.random.PRNGKey(10)
    tab_in, tab_out, want_loss = ref.sgns_epoch_device_fused(
        *ref.fuse_params(ref.SGNSParams(*map(jnp.asarray, state))), jnp.asarray(words),
        jnp.asarray(cum), jnp.asarray(cdf), jnp.asarray(keep), jnp.float32(lr), B, window,
        n_negs, 1, key)
    tables = w2v.fuse_params(w2v.SGNSParams(*(torch.from_numpy(s.copy()) for s in state)))
    draws = to_port(ref_pair_draws(jax.random.fold_in(key, 0), B, window,
                                   (B // 256, n_negs * 8)))
    loss = w2v._fused_chunk_step(*tables, _t(words).long(), _t(cum).long(), _t(cdf),
                                 _t(keep), lr, B, n_negs, draws)
    assert_step_close(w2v.unfuse_params(*tables), ref.unfuse_params(tab_in, tab_out), loss,
                      want_loss, touched_min=V // 2)


@pytest.mark.parametrize("neg_mode", ["pair", "chunk"])
def test_pair_step_matches_reference(step_inputs, neg_mode):
    vocab, words, cum, keep = step_inputs
    V, D, B, window, n_negs, lr = vocab.size, 16, 1024, 5, 4, 0.25
    neg_shape = (B // 256, n_negs * 8) if neg_mode == "chunk" else (B, n_negs)
    cdf = w2v.make_neg_cdf(vocab.counts)
    state = seeded_state(V, D)
    key = jax.random.PRNGKey(8)
    want, want_loss = ref.sgns_step_device_sampled(
        ref.SGNSParams(*map(jnp.asarray, state)), jnp.asarray(words), jnp.asarray(cum),
        jnp.asarray(cdf), jnp.asarray(keep), jnp.float32(lr), B, window, n_negs, key,
        neg_mode)
    p = w2v.SGNSParams(*(torch.from_numpy(s.copy()) for s in state))
    loss = w2v._pair_step(p, _t(words).long(), _t(cum).long(), _t(cdf), _t(keep), lr, B,
                          n_negs, to_port(ref_pair_draws(key, B, window, neg_shape)), neg_mode)
    assert_step_close(p, want, loss, want_loss, touched_min=V // 2)


def test_host_step_matches_reference(step_inputs):
    vocab, _, _, _ = step_inputs
    V, D, B, n_negs, lr = vocab.size, 16, 1024, 5, 0.1
    rng = np.random.default_rng(1)
    c = rng.integers(0, V, B).astype(np.int32)
    x = rng.integers(0, V, B).astype(np.int32)
    cdf = w2v.make_neg_cdf(vocab.counts)
    state = seeded_state(V, D)
    key = jax.random.PRNGKey(9)
    want, want_loss = ref.sgns_step(ref.SGNSParams(*map(jnp.asarray, state)), jnp.asarray(c),
                                    jnp.asarray(x), jnp.asarray(cdf), jnp.float32(lr), key,
                                    n_negs)
    p = w2v.SGNSParams(*(torch.from_numpy(s.copy()) for s in state))
    d = {"neg_u": _t(jax.random.uniform(key, (B, n_negs)))}
    loss = w2v.sgns_step(p, _t(c), _t(x), _t(cdf), lr, d)
    assert_step_close(p, want, loss, want_loss, touched_min=V // 2)


def test_block_epochs_match_reference_from_its_draws(corpus, step_inputs):
    """Two epochs of the block path through train_word2vec_device with
    otto_tpu's start and key chain injected: the same sampled indices at
    every step, the tables within float32 drift of otto_tpu's."""
    ref_ev, _ = corpus
    vocab, words, _, _ = step_inputs
    cfg = dict(name="t", vector_size=8, window=3, min_count=2, negatives=2,
               batch_size=1024, epochs=2, subsample_t=1e-2, neg_sharing="chunk",
               block_k=4, steps_per_dispatch=4)
    want = ref.train_word2vec_device(ref_ev, RefConfig(**cfg), n_aids=300)
    start = np.asarray(ref.init_params(vocab.size, 8, 42).emb_in)
    C = 256                                   # 1024 pairs in centers of 4
    n_pool = C // (256 // 4) * 16
    got = w2v.train_word2vec_device(
        port_events(ref_ev), Word2VecConfig(**cfg), 300, device="cpu", start=start,
        draws=epoch_draws(42, 2, 4, lambda key: ref_block_draws(
            key, C, 4, 3, len(words), vocab.size, n_pool)))
    assert got.report.mode == "block" and got.report.steps_per_epoch % 4 == 0
    np.testing.assert_allclose(got.emb, want.emb, rtol=1e-4, atol=1e-5)
    assert not np.allclose(got.emb, start, atol=1e-3)


# ---------------------------------------------------------------------------
# whole trainings on the 40-topic fixture
# ---------------------------------------------------------------------------
def topic_separation(model, n_aids=200):
    emb = model.embedding_by_aid(n_aids)
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
    sim = emb @ emb.T
    topic = np.arange(n_aids) // 5
    same = topic[:, None] == topic[None, :]
    off = ~np.eye(n_aids, dtype=bool)
    return sim[same & off].mean(), sim[~same].mean()


TOPICS = dict(name="t", vector_size=16, window=4, min_count=1, negatives=5,
              learning_rate=0.1, subsample_t=0)


@pytest.mark.parametrize("path,extra,mode", [
    ("device", dict(batch_size=8192, epochs=3), "pair"),
    ("device", dict(batch_size=8192, epochs=3, neg_sharing="chunk"), "block"),
    ("host", dict(batch_size=4096, epochs=4, sampler="host"), "host"),
])
def test_training_embeds_topics(path, extra, mode):
    """tests/test_word2vec.py's and test_w2v_device.py's quality test on
    the port, and the separation against otto_tpu's on the same corpus
    and settings. Their settings but fewer epochs (3 device, 4 host; they
    run 8 and 10): each step kind separates the topics well before that
    (separations ~0.45-0.6 for both packages)."""
    ev = simple_events(n_topics=40, items_per_topic=5, n_sessions=2000, sess_len=8)
    ref_train = ref.train_word2vec_device if path == "device" else ref.train_word2vec
    port_train = w2v.train_word2vec_device if path == "device" else w2v.train_word2vec
    want = ref_train(ev, RefConfig(**TOPICS, **extra), n_aids=200)
    got = port_train(port_events(ev), Word2VecConfig(**TOPICS, **extra), 200, device="cpu")
    assert got.report.mode == mode
    intra, inter = topic_separation(got)
    assert intra > inter + 0.3, (intra, inter)
    ref_intra, ref_inter = topic_separation(want)
    assert abs((intra - inter) - (ref_intra - ref_inter)) <= SEPARATION_TOL, (
        intra - inter, ref_intra - ref_inter)
    losses = got.report.epoch_loss
    assert len(losses) == extra["epochs"] and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_block_sampler_off_by_environment(monkeypatch):
    """OTTO_W2V_BLOCK=0 runs chunk mode with per-pair samples."""
    monkeypatch.setenv("OTTO_W2V_BLOCK", "0")
    ev = port_events(simple_events(n_sessions=100, sess_len=6))
    cfg = Word2VecConfig(name="t", vector_size=8, min_count=1, batch_size=512, epochs=1,
                         neg_sharing="chunk")
    assert w2v.train_word2vec_device(ev, cfg, 20, device="cpu").report.mode == "chunk"


@pytest.mark.parametrize("sampler", ["device", "host"])
def test_type_filter_raises_on_empty_vocabulary(sampler):
    ev = port_events(simple_events(n_sessions=100, sess_len=6))
    # every event is a click: carts and orders leave no word
    cfg = Word2VecConfig(name="t", types=(1, 2), vector_size=8, min_count=1)
    train = w2v.train_word2vec_device if sampler == "device" else w2v.train_word2vec
    with pytest.raises(ValueError, match="empty vocabulary"):
        train(ev, cfg, 20, device="cpu")


def test_unknown_optimizer_is_refused():
    Word2VecConfig(optimizer="sgd")
    with pytest.raises(ValueError, match="'adagrad' or 'sgd'"):
        Word2VecConfig(optimizer="adam")


# ---------------------------------------------------------------------------
# plain SGD's rate, and the step kinds that ignore it
# ---------------------------------------------------------------------------
SGD = dict(name="t", vector_size=4, window=3, min_count=2, negatives=2, batch_size=1024,
           epochs=2, subsample_t=1e-2, neg_sharing="chunk", block_k=4, steps_per_dispatch=4,
           optimizer="sgd", sgd_alpha=0.05, sgd_min_alpha=1e-3)


def test_sgd_rates_match_reference_across_resume(corpus, tmp_path, monkeypatch):
    """The rate handed to every block step of a two-epoch run is otto_tpu's
    float32 rate of that step's dispatch (:1096-1105), bit for bit; a run
    resumed after epoch 0 goes on with epoch 1's rates. The steps are
    replaced by recorders: the rates are what is compared."""
    ref_ev, ev = corpus
    want = []

    def ref_dispatch(params, *args):
        want.append(np.asarray(args[5]))          # lr_t, float32
        return params, jnp.float32(0)

    monkeypatch.setattr(ref, "sgns_epoch_device_block", ref_dispatch)
    ref.train_word2vec_device(ref_ev, RefConfig(**SGD), n_aids=300)
    assert all(w.dtype == np.float32 for w in want)
    want = np.repeat(np.array(want), SGD["steps_per_dispatch"])

    got = []

    def port_step(p, *args):
        got.append(np.float32(args[5]))           # lr
        assert args[-1] == "sgd"
        return torch.zeros(())

    monkeypatch.setattr(w2v, "_block_step", port_step)
    monkeypatch.setenv("OTTO_W2V_CKPT_EVERY", "1")
    ck = str(tmp_path / "w2v.ckpt")
    cfg = Word2VecConfig(**SGD)
    first = w2v.train_word2vec_device(ev, cfg, 300, device="cpu", checkpoint_path=ck)
    assert first.report.mode == "block" and first.report.optimizer == "sgd"
    assert len(got) == len(want) == 2 * first.report.steps_per_epoch
    np.testing.assert_array_equal(np.array(got), want)
    assert want[0] == np.float32(0.05) and len(np.unique(want)) == len(want) // 4
    half = first.report.steps_per_epoch
    got.clear()
    resumed = w2v.train_word2vec_device(ev, cfg, 300, device="cpu", checkpoint_path=ck)
    assert resumed.report.epochs == 1
    np.testing.assert_array_equal(np.array(got), want[half:])


def test_sgd_outside_block_trains_adagrad(monkeypatch):
    """otto_tpu applies 'sgd' under the block sampler only; pair steps, and
    chunk steps with the block sampler off, train with Adagrad in both
    packages (the port says so in its report)."""
    ev = simple_events(n_sessions=100, sess_len=6)
    base = dict(name="t", vector_size=8, min_count=1, batch_size=512, epochs=1)
    for sharing, block in (("pair", "1"), ("chunk", "0")):
        monkeypatch.setenv("OTTO_W2V_BLOCK", block)
        sgd, ada = (w2v.train_word2vec_device(
            port_events(ev), Word2VecConfig(**base, neg_sharing=sharing, optimizer=opt), 20,
            device="cpu") for opt in ("sgd", "adagrad"))
        assert sgd.report.mode == sharing and sgd.report.optimizer == "adagrad"
        np.testing.assert_array_equal(sgd.emb, ada.emb)
    monkeypatch.setenv("OTTO_W2V_BLOCK", "1")
    want_sgd, want_ada = (ref.train_word2vec_device(
        ev, RefConfig(**base, neg_sharing="pair", optimizer=opt), n_aids=20)
        for opt in ("sgd", "adagrad"))
    np.testing.assert_array_equal(want_sgd.emb, want_ada.emb)


def test_sgd_divergence_ends_non_finite():
    """otto_tpu's note on 'sgd' (otto_tpu/config.py:212-220): on the
    200-word topics fixture at alpha 0.05 the summed steps diverge to NaN.
    The port's tables go non-finite as well: its fixed-point sums do not
    wrap the diverging rows into finite values."""
    ev = simple_events(n_topics=40, items_per_topic=5, n_sessions=2000, sess_len=8)
    cfg = dict(TOPICS, batch_size=8192, epochs=1, neg_sharing="chunk", optimizer="sgd",
               sgd_alpha=0.05)
    want = ref.train_word2vec_device(ev, RefConfig(**cfg), n_aids=200)
    got = w2v.train_word2vec_device(port_events(ev), Word2VecConfig(**cfg), 200, device="cpu")
    assert got.report.mode == "block" and got.report.optimizer == "sgd"
    assert not np.isfinite(want.emb).any()
    assert not np.isfinite(got.emb).any() and not np.isfinite(got.report.epoch_loss).any()


def test_unbounded_adds_keep_float_semantics():
    """_add_rows_unbounded: finite rows summed as _add_rows sums them, an
    inf / NaN entry added as a float add would (inf + -inf = NaN), and rows
    near float32's largest values summed without a wrap (to inf where the
    float sum overflows)."""
    ids = torch.tensor([0, 0, 1, 2, 2, 3])
    inf, nan, big = float("inf"), float("nan"), 3e38
    rows = torch.tensor([[1.0, inf], [2.0, -inf], [0.5, nan], [-inf, 1.0], [1.5, 1.0],
                         [-0.25, 0.125]])
    table = torch.zeros(4, 2)
    w2v._add_rows_unbounded(table, ids, rows)
    want = torch.tensor([[3.0, nan], [0.5, nan], [-inf, 2.0], [-0.25, 0.125]])
    torch.testing.assert_close(table, want, equal_nan=True, rtol=0, atol=0)
    table = torch.zeros(2, 1)
    w2v._add_rows_unbounded(table, torch.tensor([0, 0, 1]), torch.tensor([[big], [big], [big]]))
    torch.testing.assert_close(table, torch.tensor([[inf], [big]]), rtol=0, atol=0)
    finite = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0], [7.0, 8.0], [9.0, 1.0],
                           [2.0, 3.0]]) * 1e-3
    a, b = torch.ones(4, 2), torch.ones(4, 2)
    w2v._add_rows_unbounded(a, ids, finite)
    w2v._add_rows(b, ids, finite)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the fused-accumulator layout
# ---------------------------------------------------------------------------
def test_fuse_params_roundtrip():
    p = w2v.SGNSParams(*(torch.from_numpy(s) for s in seeded_state(7, 3)))
    tab_in, tab_out = w2v.fuse_params(p)
    assert tab_in.shape == tab_out.shape == (7, 4)
    np.testing.assert_array_equal(tab_in[:, 3].numpy(), p.acc_in.numpy())
    for a, b in zip(w2v.unfuse_params(tab_in, tab_out), p):
        assert a.is_contiguous() and torch.equal(a, b)


FUSED = dict(name="t", vector_size=8, min_count=1, epochs=3, batch_size=1024, window=3,
             subsample_t=0, steps_per_dispatch=2, neg_sharing="chunk")


def test_fused_training_equals_chunk_training(monkeypatch):
    """OTTO_W2V_FUSED=1 turns the block sampler off and takes fused chunk
    steps; from the same generator's draws they end bit-equal to the
    chunk steps (the block sampler off) on the unfused tables."""
    ev = port_events(simple_events(n_sessions=200, sess_len=6))
    monkeypatch.setenv("OTTO_W2V_FUSED", "1")
    fused = w2v.train_word2vec_device(ev, Word2VecConfig(**FUSED), 20, device="cpu")
    assert fused.report.mode == "fused" and fused.report.optimizer == "adagrad"
    monkeypatch.setenv("OTTO_W2V_FUSED", "0")
    monkeypatch.setenv("OTTO_W2V_BLOCK", "0")
    chunk = w2v.train_word2vec_device(ev, Word2VecConfig(**FUSED), 20, device="cpu")
    assert chunk.report.mode == "chunk"
    np.testing.assert_array_equal(fused.emb, chunk.emb)
    assert fused.report.epoch_loss == chunk.report.epoch_loss
    assert not np.allclose(fused.emb, w2v.train_word2vec_device(
        ev, Word2VecConfig(**FUSED, seed=7), 20, device="cpu").emb)


def test_fused_checkpoint_reloads_unfused(tmp_path, monkeypatch):
    """A fused run's checkpoint holds the unfused tables: a chunk run
    resumes from it, and a fused run from a chunk run's, each ending
    bit-equal to the run without a break."""
    ev = port_events(simple_events(n_sessions=200, sess_len=6))
    cfg = Word2VecConfig(**FUSED)
    monkeypatch.setenv("OTTO_W2V_CKPT_EVERY", "1")
    ends = {}
    for first, then in (("1", "0"), ("0", "1")):
        ck = str(tmp_path / f"w2v-{first}.ckpt")
        monkeypatch.setenv("OTTO_W2V_BLOCK", "0")
        monkeypatch.setenv("OTTO_W2V_FUSED", first)
        whole = w2v.train_word2vec_device(ev, cfg, 20, device="cpu", checkpoint_path=ck)
        state, step = load_checkpoint(ck, w2v._state(
            w2v.init_params(whole.vocab.size, 8, 0, "cpu"), torch.Generator()))
        assert step == 2 and state["emb_in"].shape == (whole.vocab.size, 8)
        monkeypatch.setenv("OTTO_W2V_FUSED", then)
        resumed = w2v.train_word2vec_device(ev, cfg, 20, device="cpu", checkpoint_path=ck)
        assert resumed.report.epochs == 1
        assert resumed.report.mode == ("fused" if then == "1" else "chunk")
        np.testing.assert_array_equal(resumed.emb, whole.emb)
        ends[first] = whole.emb
    np.testing.assert_array_equal(ends["1"], ends["0"])


def test_trained_model_loads_in_reference(tmp_path):
    ev = simple_events()
    cfg = Word2VecConfig(name="t", vector_size=8, min_count=1, epochs=1, batch_size=256,
                         subsample_t=0)
    got = w2v.train_word2vec_device(port_events(ev), cfg, 13, device="cpu")
    got.save(str(tmp_path / "w.npz"))
    back = ref.Word2Vec.load(str(tmp_path / "w.npz"), RefConfig(name="t"))
    np.testing.assert_array_equal(back.emb, got.emb)
    np.testing.assert_array_equal(back.embedding_by_aid(20), got.embedding_by_aid(20))
    assert np.all(got.embedding_by_aid(20)[15] == 0)   # aid 15 never seen


# ---------------------------------------------------------------------------
# checkpoints and resume (the checkpoint half of tests/test_aux.py)
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_and_checks(tmp_path):
    p = str(tmp_path / "ckpt.pt")
    assert load_checkpoint(p, {"x": torch.zeros(1)}) is None
    state = {"w": torch.arange(6.0).reshape(2, 3), "g": torch.Generator().get_state()}
    save_checkpoint(p, state, step=7, meta={"V": 2})
    restored, step = load_checkpoint(p, state, expect_meta={"V": 2})
    assert step == 7 and torch.equal(restored["w"], state["w"])
    assert torch.equal(restored["g"], state["g"])
    assert load_checkpoint(p, {"w": torch.zeros(3, 3), "g": state["g"]}) is None   # shape
    assert load_checkpoint(p, {"w": state["w"]}) is None                           # count
    assert load_checkpoint(p, {"v": state["w"], "g": state["g"]}) is None          # name
    assert load_checkpoint(p, state, expect_meta={"V": 3}) is None                 # meta
    save_checkpoint(p, state, step=3)
    assert load_checkpoint(p, state, expect_meta={"V": 2}) is None
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


RESUME = dict(name="t", vector_size=8, min_count=1, epochs=3, batch_size=1024, window=3,
              subsample_t=0, steps_per_dispatch=2)


@pytest.mark.parametrize("sharing", ["pair", "chunk"])
def test_resume_reproduces_uninterrupted_run(tmp_path, monkeypatch, sharing):
    """The last checkpoint holds the epoch-2 state and the generator's;
    a rerun resumes there and ends bit-equal to the run without a break."""
    ev = port_events(simple_events(n_sessions=200, sess_len=6))
    cfg = Word2VecConfig(**RESUME, neg_sharing=sharing)
    ck = str(tmp_path / "w2v.ckpt")
    monkeypatch.setenv("OTTO_W2V_CKPT_EVERY", "1")
    m1 = w2v.train_word2vec_device(ev, cfg, 20, device="cpu", checkpoint_path=ck)
    assert os.path.exists(ck) and m1.report.epochs == 3
    m2 = w2v.train_word2vec_device(ev, cfg, 20, device="cpu", checkpoint_path=ck)
    assert m2.report.epochs == 1
    np.testing.assert_array_equal(m1.emb, m2.emb)
    monkeypatch.delenv("OTTO_W2V_CKPT_EVERY")
    m3 = w2v.train_word2vec_device(ev, cfg, 20, device="cpu")
    np.testing.assert_array_equal(m1.emb, m3.emb)


@pytest.mark.parametrize("change", ["words", "seed"])
def test_stale_checkpoint_is_discarded(tmp_path, monkeypatch, change):
    """A checkpoint of another vocabulary (its tables have other shapes)
    or another fingerprint is not restored: the run starts over and equals
    a run without one."""
    ev = port_events(simple_events(n_sessions=200, sess_len=6))
    ck = str(tmp_path / "w2v.ckpt")
    monkeypatch.setenv("OTTO_W2V_CKPT_EVERY", "1")
    w2v.train_word2vec_device(ev, Word2VecConfig(**RESUME), 20, device="cpu",
                              checkpoint_path=ck)
    cfg = Word2VecConfig(**RESUME)
    if change == "words":
        ev = ev.select(np.flatnonzero(ev.aid < 10))   # one topic: 3 of 6 words
    else:
        cfg = Word2VecConfig(**{**RESUME, "seed": 7})
    got = w2v.train_word2vec_device(ev, cfg, 20, device="cpu", checkpoint_path=ck)
    assert got.report.epochs == 3
    monkeypatch.delenv("OTTO_W2V_CKPT_EVERY")
    np.testing.assert_array_equal(
        got.emb, w2v.train_word2vec_device(ev, cfg, 20, device="cpu").emb)
