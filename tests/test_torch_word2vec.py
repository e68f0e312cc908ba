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


def test_block_step_matches_reference(step_inputs):
    vocab, words, cum, keep = step_inputs
    V, D, C, k, window, n_negs, lr = vocab.size, 16, 512, 4, 5, 4, 0.25
    Ks = n_negs * 8
    n_pool = C // (256 // k) * Ks
    prob, alias = w2v.make_alias(vocab.counts, 0.75)
    pos_info = w2v.pack_position_info(cum)
    state = seeded_state(V, D)
    key = jax.random.PRNGKey(7)
    want, want_loss = jax.jit(ref._sgns_step_body_block, static_argnums=(7, 8, 9, 10))(
        ref.SGNSParams(*map(jnp.asarray, state)), jnp.asarray(words), jnp.asarray(pos_info),
        jnp.asarray(prob), jnp.asarray(alias), jnp.asarray(keep), jnp.float32(lr),
        C, k, window, n_negs, key)
    p = w2v.SGNSParams(*(torch.from_numpy(s.copy()) for s in state))
    loss = w2v._block_step(
        p, _t(words).long(), _t(pos_info).long(), _t(prob), _t(alias).long(), _t(keep), lr,
        k, n_negs, to_port(ref_block_draws(key, C, k, window, len(words), V, n_pool)))
    assert_step_close(p, want, loss, want_loss, touched_min=V // 2)


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


def test_sgd_is_refused():
    with pytest.raises(ValueError, match="measured negative"):
        Word2VecConfig(optimizer="sgd")


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
