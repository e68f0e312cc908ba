"""The port's host layer against otto_tpu's: config defaults, session
packing, the train / test split and recall@20 must agree exactly; the
on-device session generator must keep otto_tpu's schema and structure."""
import dataclasses

import numpy as np
import pytest
import torch

from otto_tpu import config as ref_config
from otto_tpu.data import batching as ref_batching
from otto_tpu.data import split as ref_split
from otto_tpu.data.schema import Labels as RefLabels
from otto_tpu.data.synthetic import SyntheticSpec as RefSpec
from otto_tpu.data.synthetic import generate as ref_generate
from otto_tpu.eval import recall as ref_recall
from otto_tpu.models import word2vec as ref_word2vec
from otto_tpu_torch import config, convert
from otto_tpu_torch.data import batching, split, synthetic
from otto_tpu_torch.data.schema import Events, Labels
from otto_tpu_torch.eval import recall
from otto_tpu_torch.models import word2vec


@pytest.fixture(scope="module")
def events():
    """otto_tpu's synthetic events, and the same rows as port Events."""
    ev = ref_generate(RefSpec(n_sessions=600, n_aids=400, max_len=80,
                              mean_len=12, span_days=21, seed=3))
    return ev, Events(ev.session, ev.aid, ev.ts, ev.type)


def test_config_matches_reference():
    assert list(config.TYPES) == ref_config.TYPES
    assert config.TYPE2ID == ref_config.TYPE2ID
    assert config.TYPE_WEIGHTS == ref_config.TYPE_WEIGHTS
    covis = ref_config.CoVisConfig()
    assert list(config.COVIS_FIRST_N) == covis.names
    assert config.COVIS_FIRST_N == covis.retrieval_first_n
    ref_ret = dataclasses.asdict(ref_config.RetrievalConfig())
    for f in dataclasses.fields(config.RetrievalConfig):
        assert getattr(config.RetrievalConfig(), f.name) == ref_ret[f.name], f.name
    ref_gbdt = ref_config.GBDTConfig(n_trees=7, max_depth=3, n_bins=16)
    got = config.GBDTConfig.from_dict(dataclasses.asdict(ref_gbdt))
    assert (got.n_trees, got.max_depth, got.n_bins) == (7, 3, 16)
    default = dataclasses.asdict(ref_config.GBDTConfig())
    assert config.GBDTConfig.from_dict(default) == config.GBDTConfig()


@pytest.mark.parametrize("name", ["GBDTConfig", "RankerConfig", "Word2VecConfig"])
def test_training_config_defaults_match_reference(name):
    """Every field the port has, by name, type and default; the port leaves
    out otto_tpu's trees_per_dispatch (a dispatch-deadline workaround), the
    MLP tower's settings, and the SGD and MXU-padding fields of the
    word2vec models."""
    got, want = getattr(config, name)(), dataclasses.asdict(getattr(ref_config, name)())
    fields = [f.name for f in dataclasses.fields(got)]
    assert set(fields) <= set(want)
    for f in fields:
        assert getattr(got, f) == want[f] and type(getattr(got, f)) is type(want[f]), f
    left_out = set(want) - set(fields)
    if name == "GBDTConfig":
        assert left_out == {"trees_per_dispatch"}
    elif name == "Word2VecConfig":
        assert left_out == {"sgd_alpha", "sgd_min_alpha", "padded_dim"}
    else:
        assert {"neg_to_pos_ratio", "max_neg_per_session", "device_select",
                "seed"} == set(fields)


@pytest.mark.parametrize("name", ["CoVisConfig", "PopularityConfig", "DataConfig"])
def test_counting_config_matches_reference(name):
    """Every field, and so the counting machinery's defaults (host_spill,
    spill_prune_min_rows, pair_budget, max_run_rows) that the spill-time
    prune depends on."""
    got, want = getattr(config, name)(), getattr(ref_config, name)()
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (config.HOUR, config.DAY, config.KEEP_TOP_K) == \
        (ref_config.HOUR, ref_config.DAY, ref_config.KEEP_TOP_K)
    if name == "CoVisConfig":
        assert got.names == want.names


@pytest.mark.parametrize("buckets", [(32, 512), (8, 16, 24, 32, 48, 64), (8,)])
def test_pack_sessions_filled_matches_reference(events, buckets):
    ref_ev, ev = events
    want = ref_batching.pack_sessions_filled(ref_ev, buckets)
    got = batching.pack_sessions_filled(ev, buckets)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        for name in batching.FilledSessions._fields:
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), name)
            assert getattr(g, name).dtype == getattr(w, name).dtype, name


@pytest.mark.parametrize("batch", [3, 50, 5000])
def test_filled_microbatches_match_reference(events, batch):
    ref_ev, ev = events
    for g_p, w_p in zip(batching.pack_sessions_filled(ev, (16, 64)),
                        ref_batching.pack_sessions_filled(ref_ev, (16, 64))):
        got = list(batching.iter_filled_microbatches(g_p, batch))
        want = list(ref_batching.iter_filled_microbatches(w_p, batch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.n_rows == batch
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
    with pytest.raises(ValueError):
        batching.pad_filled(got[0], batch - 1)


@pytest.mark.parametrize("packed", [True, False])
def test_dedup_events_matches_reference(events, packed):
    """Duplicated rows appended; `packed=False` takes the four-key lexsort
    (a negative aid rules out the packed int64 key)."""
    ref_ev, _ = events
    rng = np.random.default_rng(4)
    dup = rng.integers(0, len(ref_ev), 200)
    rows = np.concatenate([np.arange(len(ref_ev)), dup])
    ref_ev = ref_ev.select(rows)
    if not packed:
        ref_ev.aid[5] = -3
    ev = Events(ref_ev.session, ref_ev.aid, ref_ev.ts, ref_ev.type)
    want = ref_batching.dedup_events(ref_ev)
    got = batching.dedup_events(ev)
    assert len(got) < len(ev)
    for col in ("session", "aid", "ts", "type"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
        assert getattr(got, col).dtype == getattr(want, col).dtype


@pytest.mark.parametrize("buckets", [(8, 32, 128, 512), (16, 4), (8,)])
def test_pack_sessions_matches_reference(events, buckets):
    ref_ev, ev = events
    want = ref_batching.pack_sessions(ref_ev, buckets)
    got = batching.pack_sessions(ev, buckets)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        for name in batching.PaddedSessions._fields:
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), name)
            assert getattr(g, name).dtype == getattr(w, name).dtype, name


@pytest.mark.parametrize("batch", [7, 64, 1000])
def test_microbatches_match_reference(events, batch):
    ref_ev, ev = events
    for g_p, w_p in zip(batching.pack_sessions(ev, (16, 64)),
                        ref_batching.pack_sessions(ref_ev, (16, 64))):
        got = list(batching.iter_microbatches(g_p, batch))
        want = list(ref_batching.iter_microbatches(w_p, batch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype


@pytest.mark.parametrize("seed", [0, 9])
def test_split_matches_reference(events, seed):
    ref_ev, ev = events
    want = ref_split.split_events(ref_ev, test_days=7, seed=seed)
    got = split.split_events(ev, test_days=7, seed=seed)
    for part in ("train", "test"):
        for col in ("session", "aid", "ts", "type"):
            np.testing.assert_array_equal(
                getattr(getattr(got, part), col), getattr(getattr(want, part), col))
    for col in ("session", "type", "aid"):
        np.testing.assert_array_equal(getattr(got.labels, col),
                                      getattr(want.labels, col))
    assert len(got.test) and len(got.labels)


def test_recall_matches_reference(events):
    ref_ev, _ = events
    sp = ref_split.split_events(ref_ev, test_days=7, seed=1)
    rng = np.random.default_rng(4)
    sessions = np.unique(sp.test.session)
    preds = {}
    for t in config.TYPES:
        # predictions for most sessions, in shuffled order; labelled aids
        # planted in some rows; -1 padding; one session predicted twice
        s = rng.permutation(sessions)[: int(len(sessions) * 0.9)]
        s = np.append(s, s[0]).astype(np.int32)
        a = rng.integers(-1, 400, (len(s), 25)).astype(np.int32)
        lab = sp.labels.for_type(config.TYPE2ID[t])
        row = {int(x): i for i, x in enumerate(s[:-1])}
        for j in range(0, len(lab), 2):
            if int(lab.session[j]) in row:
                a[row[int(lab.session[j])], rng.integers(0, 25)] = lab.aid[j]
        preds[t] = (s, a)
    lab = sp.labels
    want = ref_recall.evaluate_topk(preds, lab)
    got = recall.evaluate_topk(preds, Labels(lab.session, lab.type, lab.aid))
    assert got == want
    assert 0 < got["total"] < 1
    # a type without labels scores 0, as in the reference
    no_orders = lab.type != 2
    ref_l = RefLabels(lab.session[no_orders], lab.type[no_orders], lab.aid[no_orders])
    got = recall.evaluate_topk(
        preds, Labels(ref_l.session, ref_l.type, ref_l.aid))
    assert got == ref_recall.evaluate_topk(preds, ref_l)
    assert got["orders"] == 0.0


SPEC = synthetic.SyntheticSpec(n_sessions=500, n_aids=3000, max_len=48,
                               mean_len=10, seed=5)


def test_generate_schema_and_structure():
    ev = synthetic.generate(SPEC, "cpu")
    assert ev.session.dtype == np.int32 and ev.type.dtype == np.int8
    # (session, ts)-sorted, every session present with 2..max_len events
    order = np.lexsort((ev.ts, ev.session))
    np.testing.assert_array_equal(order, np.arange(len(ev)))
    lens = np.bincount(ev.session, minlength=SPEC.n_sessions)
    assert lens.min() >= 2 and lens.max() <= SPEC.max_len
    assert abs(np.median(lens) - SPEC.mean_len) <= 3
    assert ev.aid.min() >= 0 and ev.aid.max() < SPEC.n_aids
    assert set(np.unique(ev.type)) == {0, 1, 2}
    # the funnel: every order targets an aid carted earlier in its session
    for s in np.unique(ev.session[ev.type == 2])[:50]:
        m = ev.session == s
        a, t = ev.aid[m], ev.type[m]
        for i in np.flatnonzero(t == 2):
            assert a[i] in a[:i][t[:i] == 1]
    # zipf popularity (aid == popularity rank): the top 1% of aids take a
    # large share of the events
    share = (ev.aid < SPEC.n_aids // 100).mean()
    assert share > 0.2


def test_generate_is_seeded():
    a, b = synthetic.generate(SPEC, "cpu"), synthetic.generate(SPEC, "cpu")
    c = synthetic.generate(dataclasses.replace(SPEC, seed=6), "cpu")
    for col in ("session", "aid", "ts", "type"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col))
    assert not np.array_equal(a.aid[:100], c.aid[:100])


def test_generate_feeds_split_and_packing():
    """The on-device generator's events go through the port's split and
    packing into every length bucket, as chip_smoke.py drives them."""
    spec = dataclasses.replace(SPEC, n_sessions=3000, max_len=200, mean_len=18)
    sp = split.split_events(synthetic.generate(spec, torch.device("cpu")),
                            test_days=7, seed=0)
    assert len(sp.train) and len(sp.labels)
    packed = batching.pack_sessions(sp.test, (8, 32, 128))
    assert [p.aid.shape[1] for p in packed] == [8, 32, 128]


def test_build_config_matches_reference():
    """The word2vec and k-means settings the table build reads."""
    for name, cfg in config.W2VEC_MODELS.items():
        ref = ref_config.W2VEC_MODELS[name]
        for f in dataclasses.fields(config.Word2VecConfig):
            assert getattr(cfg, f.name) == getattr(ref, f.name), (name, f.name)
    assert list(config.W2VEC_MODELS) == list(ref_config.W2VEC_MODELS)
    ref_default = ref_config.Word2VecConfig()
    for f in dataclasses.fields(config.Word2VecConfig):
        assert getattr(config.Word2VecConfig(), f.name) == getattr(ref_default, f.name)
    ref_km = ref_config.KMeansConfig()
    for f in dataclasses.fields(config.KMeansConfig):
        assert getattr(config.KMeansConfig(), f.name) == getattr(ref_km, f.name), f.name


def test_events_concat_matches_reference(events):
    ref_ev, ev = events
    half = len(ev) // 2
    want = ref_ev.select(np.arange(half)).concat(ref_ev.select(np.arange(half, len(ev))))
    got = ev.select(np.arange(half)).concat(ev.select(np.arange(half, len(ev))))
    for col in ("session", "aid", "ts", "type"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
        assert getattr(got, col).dtype == getattr(want, col).dtype


@pytest.mark.parametrize("types,min_count", [((0, 1, 2), 5), ((1, 2), 1), ((0,), 0)])
def test_build_vocab_matches_reference(events, types, min_count):
    ref_ev, ev = events
    want = ref_word2vec.build_vocab(ref_ev, types, min_count, 400)
    got = word2vec.build_vocab(ev, types, min_count, 400)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert got.size == want.size


def test_word2vec_load_reads_reference_npz(events, tmp_path):
    """An otto_tpu-saved model loads into the port; the port's save writes
    a file otto_tpu loads back."""
    ref_ev, _ = events
    cfg = ref_config.W2VEC_MODELS["w2v-1-2"]
    vocab = ref_word2vec.build_vocab(ref_ev, cfg.types, 2, 400)
    emb = np.random.default_rng(0).normal(size=(vocab.size, 12)).astype(np.float32)
    ref = ref_word2vec.Word2Vec(cfg, vocab, emb)
    ref.save(str(tmp_path / "ref.npz"))
    got = word2vec.Word2Vec.load(str(tmp_path / "ref.npz"), config.W2VEC_MODELS["w2v-1-2"])
    np.testing.assert_array_equal(got.emb, emb)
    for g, w in zip(got.vocab, vocab):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.embedding_by_aid(400), ref.embedding_by_aid(400))
    carried = convert.word2vec_from_numpy(ref)
    assert carried.cfg == config.W2VEC_MODELS["w2v-1-2"]
    np.testing.assert_array_equal(carried.embedding_by_aid(400), ref.embedding_by_aid(400))
    got.save(str(tmp_path / "port.npz"))
    back = ref_word2vec.Word2Vec.load(str(tmp_path / "port.npz"), cfg)
    np.testing.assert_array_equal(back.emb, emb)
    np.testing.assert_array_equal(back.vocab.word_of_aid, vocab.word_of_aid)
    np.savez(str(tmp_path / "bad.npz"), aid_of_word=vocab.aid_of_word,
             word_of_aid=vocab.word_of_aid, counts=vocab.counts, emb=emb[:-1])
    with pytest.raises(ValueError):
        word2vec.Word2Vec.load(str(tmp_path / "bad.npz"), got.cfg)
