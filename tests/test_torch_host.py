"""The port's host layer against otto_tpu's: config defaults, session
packing, the train / test split and recall@20 must agree exactly; the
on-device session generator must keep otto_tpu's schema and structure."""
import dataclasses
import json

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


@pytest.mark.parametrize("mesh", [
    {}, dict(data_parallel=4, model_parallel=2),
    dict(data_parallel=-1, model_parallel=4, data_axis="d", model_axis="m")])
def test_mesh_config_round_trips_with_reference(tmp_path, mesh):
    """The `mesh` section: otto_tpu's config.json reads into the port's
    MeshConfig, the port's into otto_tpu's, field for field; a work dir
    written under another mesh is not stale (the mesh shapes no artifact)."""
    ref = ref_config.Config(mesh=ref_config.MeshConfig(**mesh))
    ref_config.config_to_json(ref, str(tmp_path / "ref.json"))
    got = config.config_from_json(str(tmp_path / "ref.json"))
    assert dataclasses.asdict(got.mesh) == dataclasses.asdict(ref.mesh)
    assert dataclasses.asdict(config.MeshConfig()) == dataclasses.asdict(ref_config.MeshConfig())
    config.config_to_json(config.Config(mesh=config.MeshConfig(**mesh)),
                          str(tmp_path / "port.json"))
    back = ref_config.config_from_json(str(tmp_path / "port.json"))
    assert dataclasses.asdict(back.mesh) == dataclasses.asdict(ref.mesh)
    with open(tmp_path / "ref.json") as fh:
        assert config.stale_sections(config.Config(), json.load(fh)) == []


@pytest.mark.parametrize("name", ["GBDTConfig", "RankerConfig", "Word2VecConfig"])
def test_training_config_defaults_match_reference(name):
    """Every field the port has, by name, type and default; the port leaves
    out otto_tpu's trees_per_dispatch (a dispatch-deadline workaround) and
    the MXU-padding field of the word2vec models, and has every field of
    the ranker's (the MLP tower's and downsampling's)."""
    got, want = getattr(config, name)(), dataclasses.asdict(getattr(ref_config, name)())
    fields = [f.name for f in dataclasses.fields(got)]
    assert set(fields) <= set(want)
    for f in fields:
        assert getattr(got, f) == want[f] and type(getattr(got, f)) is type(want[f]), f
    left_out = set(want) - set(fields)
    if name == "GBDTConfig":
        assert left_out == {"trees_per_dispatch"}
    elif name == "Word2VecConfig":
        assert left_out == {"padded_dim"}
    else:
        assert left_out == set()


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
    ev = synthetic.generate_device(SPEC, "cpu")
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
    a, b = synthetic.generate_device(SPEC, "cpu"), synthetic.generate_device(SPEC, "cpu")
    c = synthetic.generate_device(dataclasses.replace(SPEC, seed=6), "cpu")
    for col in ("session", "aid", "ts", "type"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col))
    assert not np.array_equal(a.aid[:100], c.aid[:100])


def test_generate_feeds_split_and_packing():
    """The on-device generator's events go through the port's split and
    packing into every length bucket, as chip_smoke.py drives them."""
    spec = dataclasses.replace(SPEC, n_sessions=3000, max_len=200, mean_len=18)
    sp = split.split_events(synthetic.generate_device(spec, torch.device("cpu")),
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


@pytest.mark.parametrize("spec", [
    dict(n_sessions=700, n_aids=900, max_len=80, mean_len=12, span_days=21, seed=3),
    dict(n_sessions=300, n_aids=50, max_len=20, seed=11, p_cart=0.3),
])
def test_numpy_generate_matches_reference(spec):
    """The numpy generator draws otto_tpu's events, bit for bit."""
    want = ref_generate(RefSpec(**spec))
    got = synthetic.generate(synthetic.SyntheticSpec(**spec))
    for col in ("session", "aid", "ts", "type"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
        assert getattr(got, col).dtype == getattr(want, col).dtype


def test_parquet_round_trip_with_reference(events, tmp_path):
    """Each package reads the other's parquet files (pyarrow only there)."""
    from otto_tpu.data.schema import Events as RefEvents

    ref_ev, ev = events
    ev.to_parquet(str(tmp_path / "port.parquet"))
    ref_ev.to_parquet(str(tmp_path / "ref.parquet"))
    for got, want in ((RefEvents.from_parquet(str(tmp_path / "port.parquet")), ref_ev),
                      (Events.from_parquet(str(tmp_path / "ref.parquet")), ev)):
        for col in ("session", "aid", "ts", "type"):
            np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
            assert getattr(got, col).dtype == getattr(want, col).dtype
    lab = Labels(np.array([4, 5]), np.array([2, 0]), np.array([7, 8]))
    lab.to_parquet(str(tmp_path / "lab.parquet"))
    back = RefLabels.from_parquet(str(tmp_path / "lab.parquet"))
    assert (back.session.tolist(), back.type.tolist(), back.aid.tolist()) == \
        ([4, 5], [2, 0], [7, 8])
    assert Labels.from_parquet(str(tmp_path / "lab.parquet")).aid.dtype == np.int32


def test_reports_match_reference():
    """test_aux.py's report_name and describe_numeric, on both packages."""
    from otto_tpu.utils import reports as ref_reports
    from otto_tpu_torch.utils import reports

    name = reports.report_name("eval", tag="v1")
    assert name.startswith("eval-") and "-v1" in name
    assert reports.git_hash() == ref_reports.git_hash()
    for v in (np.arange(101), np.random.default_rng(0).normal(size=37), np.array([])):
        got, want = reports.describe_numeric(v), ref_reports.describe_numeric(v)
        assert list(got) == list(want)
        np.testing.assert_array_equal(list(got.values()), list(want.values()))
    d = reports.describe_numeric(np.arange(101))
    assert d["min"] == 0 and d["max"] == 100 and d["50%"] == 50


def test_timing_harness(tmp_path):
    """test_aux.py's StageTimer and time_fn (host clock for CPU outputs),
    and a profiler trace."""
    from otto_tpu_torch.utils import timing

    t = timing.StageTimer()
    with t.stage("a"):
        sum(range(1000))
    with t.stage("a"):
        pass
    assert list(t.stages) == ["a"] and t.stages["a"] > 0 and "total" in t.report()
    r = timing.time_fn("add", lambda x: x + 1, torch.zeros(8), iters=3, warmup=2)
    assert r.name == "add" and len(r.runs) == 3 and r.mean_s >= 0 and r.compile_s >= 0
    assert r.per_second > 0 and r.items_per_second(10) > 0
    with timing.profiler_trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    timing.device_sync(torch.zeros(2))   # CPU outputs: nothing to wait for


# ---------------------------------------------------------------------------
# the host API otto_tpu's callers read: Events' counts, the padded lanes'
# mask, Config.replace, the kept aids' slots
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows", ["all", "half", "none"])
def test_events_counts_match_reference(events, rows):
    ref_ev, ev = events
    pick = {"all": slice(None), "half": slice(0, len(ev) // 2), "none": slice(0, 0)}[rows]
    want = ref_ev.__class__(*(getattr(ref_ev, c)[pick] for c in ("session", "aid", "ts", "type")))
    got = ev.select(pick)
    assert (got.n_sessions, got.n_aids) == (want.n_sessions, want.n_aids)
    assert isinstance(got.n_sessions, int) and isinstance(got.n_aids, int)


@pytest.mark.parametrize("buckets", [(8, 32, 128, 512), (4,)])
def test_valid_mask_matches_reference(events, buckets):
    ref_ev, ev = events
    for g, w in zip(batching.pack_sessions(ev, buckets),
                    ref_batching.pack_sessions(ref_ev, buckets)):
        for gm, wm in zip(batching.iter_microbatches(g, 48),
                          ref_batching.iter_microbatches(w, 48)):
            got, want = gm.valid_mask(), wm.valid_mask()
            assert got.dtype == want.dtype == bool
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, gm.aid >= 0)


def test_config_replace_matches_reference():
    """Config.replace swaps sections and fields as otto_tpu's does, leaving
    the original as it was."""
    base, ref_base = config.Config(), ref_config.Config()
    got = base.replace(ranker_backend="mlp", work_dir="w",
                       kmeans=dataclasses.replace(base.kmeans, max_iter=3))
    want = ref_base.replace(ranker_backend="mlp", work_dir="w",
                            kmeans=dataclasses.replace(ref_base.kmeans, max_iter=3))
    assert (got.ranker_backend, got.work_dir, got.kmeans.max_iter) == (
        want.ranker_backend, want.work_dir, want.kmeans.max_iter)
    assert base == config.Config() and got.covis == base.covis
    with pytest.raises(TypeError):
        base.replace(no_such_section=1)


@pytest.mark.parametrize("keep_aids", [4, 16])
def test_session_aids_valid_matches_reference(events, keep_aids):
    import jax.numpy as jnp

    from otto_tpu.engine import session_stats as ref_stats
    from otto_tpu_torch.engine import session_stats

    ref_ev, ev = events
    (w,) = ref_batching.iter_microbatches(ref_batching.pack_sessions(ref_ev, (32,))[0], 700)
    want = ref_stats.compute_session_aids(jnp.asarray(w.aid), jnp.asarray(w.ts),
                                          jnp.asarray(w.type), keep_aids).valid
    got = session_stats.compute_session_aids(torch.from_numpy(w.aid), torch.from_numpy(w.ts),
                                             torch.from_numpy(w.type), keep_aids).valid
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()
