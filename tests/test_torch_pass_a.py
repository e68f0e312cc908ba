"""Training pass A: otto_tpu_torch against otto_tpu on the same batches.

Batches of 1,500 sessions with ids past 2^10 (the label keys are 45 bits:
a join truncated to 32 bits would collide there), random candidates with
padding, random source flags and float features. Bit-equal: the packed
meta, the label bits, the downsampled rows (one numpy rng per type over
several batches), the float16 rows and the per-source report, which must
also equal otto_tpu's host `eval_retrieved_by_source` + `recall_at_k`.
The device keep bits draw from torch's generator, so they are held to
otto_tpu's semantics, not to its draws.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.config import RankerConfig as RefRankerConfig
from otto_tpu.data.schema import Labels as RefLabels
from otto_tpu.engine import rank as ref_rank
from otto_tpu.engine import retrieval as ref_retrieval
from otto_tpu.eval import per_source as ref_per_source
from otto_tpu.eval.recall import recall_at_k
from otto_tpu_torch.config import RankerConfig
from otto_tpu_torch.data.schema import Labels
from otto_tpu_torch.engine import rank as port_rank
from otto_tpu_torch.engine import retrieval as port_retrieval
from otto_tpu_torch.eval import per_source as port_per_source
from otto_tpu_torch.pipeline import runner as port_runner

F = len(ref_retrieval.FEATURE_NAMES)
S, C, N_AIDS = 1500, 40, 3000
N_BATCHES = 3
AID_BITS = ref_retrieval.AID_BITS


@functools.lru_cache(maxsize=None)
def _arrays():
    """Per batch (session, cand [S, C], keep, keep-filtered feats) and the
    labels; batch 1 has a padded tail (keep filter), batch 2 no positive of
    type 2."""
    rng = np.random.default_rng(0)
    out = []
    lab = [[], [], []]
    for bi in range(N_BATCHES):
        n_keep = S - 37 if bi == 1 else S
        session = (np.arange(n_keep) * 3 + 5000 + bi * 10 * S).astype(np.int32)
        cand = np.full((S, C), -1, np.int32)
        for i in range(S):
            n = int(rng.integers(0, C + 1))
            cand[i, :n] = rng.choice(N_AIDS, n, replace=False)
        feats = rng.normal(size=(S, C, F)).astype(np.float32) * 1e3
        feats[:, :, ref_retrieval.FEATURE_INDEX["src_any"]] = cand >= 0
        for name in ref_retrieval.SOURCE_FLAGS[1:]:
            feats[:, :, ref_retrieval.FEATURE_INDEX[name]] = (
                (rng.random((S, C)) < 0.4) & (cand >= 0))
        feats[0, 0, :5] = [1e6, -1e6, 65519.0, 65520.0, np.inf]   # f16 clip
        keep = None if n_keep == S else np.arange(n_keep)
        kf = feats if keep is None else feats[keep]
        kc = cand if keep is None else cand[keep]
        for i in range(n_keep):
            real = kc[i][kc[i] >= 0]
            for t in range(3):
                if bi == 2 and t == 2:
                    continue
                for a in real[rng.random(len(real)) < 0.05 * (t + 1)]:
                    lab[t].append((session[i], a))
                if rng.random() < 0.2:     # a label not among the candidates
                    lab[t].append((session[i], int(rng.integers(N_AIDS, 2 * N_AIDS))))
        out.append((session, cand, keep, kf))
    # a labelled session that no batch retrieves
    lab[0].append((10 ** 6, 7))
    rows = [(s, a, t) for t in range(3) for s, a in lab[t]]
    s, a, t = (np.array(c) for c in zip(*rows))
    return out, (s.astype(np.int32), t.astype(np.int8), a.astype(np.int32))


def world():
    """-> (ref batches, port batches, ref labels, port labels), the batches
    new each call (unpacking the meta moves a batch's candidates to the
    host)."""
    arrays, (s, t, a) = _arrays()
    ref_b = [ref_retrieval.RetrievedBatch(
        session=session, cand=jnp.asarray(cand), feats=jnp.asarray(kf),
        ts_order=jnp.asarray(cand), keep=keep) for session, cand, keep, kf in arrays]
    port_b = [port_retrieval.RetrievedBatch(
        session=session, cand=torch.from_numpy(cand), feats=torch.from_numpy(kf),
        ts_order=torch.from_numpy(cand), keep=keep) for session, cand, keep, kf in arrays]
    return ref_b, port_b, RefLabels(session=s, type=t, aid=a), Labels(s, t, a)


def _ref_meta_bits(b, ref_l):
    meta, bits = b.pack_meta_labels(ref_retrieval.label_keys_device(ref_l))
    return np.asarray(meta), np.asarray(bits)


def _port_meta_bits(b, labels):
    meta, bits = b.pack_meta_labels(port_retrieval.label_keys_device(labels, "cpu"))
    return meta, bits


@pytest.mark.parametrize("bi", range(N_BATCHES))
def test_pack_meta_and_label_bits_bit_equal(bi):
    ref_b, port_b, ref_l, labels = world()
    want_meta, want_bits = _ref_meta_bits(ref_b[bi], ref_l)
    meta, bits = _port_meta_bits(port_b[bi], labels)
    assert meta.dtype == torch.int32 and bits.dtype == torch.uint8
    assert torch.equal(port_b[bi].pack_meta(), meta)
    np.testing.assert_array_equal(meta.numpy(), want_meta)
    np.testing.assert_array_equal(bits.numpy(), want_bits)
    assert bits.numpy().any()
    # unpack: the keep-filtered candidates and the flag bits
    flags = port_b[bi].unpack_meta(meta)
    np.testing.assert_array_equal(flags, ref_b[bi].unpack_meta(ref_b[bi].pack_meta()))
    np.testing.assert_array_equal(port_b[bi].cand, ref_b[bi].cand)


def test_label_keys_are_45_bits():
    """Sessions past 2^10: a 32-bit key would merge these two."""
    labels = Labels(session=np.array([1, 2 ** 11 + 1]), type=np.array([0, 0]),
                    aid=np.array([5, 5]))
    keys = port_retrieval.label_keys_device(labels, "cpu")
    assert keys[0].dtype == torch.int64 and len(set(keys[0].tolist())) == 2
    assert keys[0].max() >= 2 ** 32 and keys[1].tolist() == [-1]
    cand = torch.tensor([[5, 5, -1]], dtype=torch.int32)
    bits = port_retrieval._label_bits_program(
        cand, torch.tensor([2 ** 11 + 1], dtype=torch.int32), *keys)
    assert bits.tolist() == [[1, 1, 0]]


def test_label_keep_bits_program_semantics():
    """Keep bits (3-5): label bits unchanged; every positive of a positive
    session keeps; kept negatives per session = min(ratio * n_pos, cap,
    available negatives); nothing keeps on padding or positive-free
    sessions; the same generator seed gives the same bits."""
    rng = np.random.default_rng(0)
    Sn, Cn = 64, 96
    cand = rng.integers(0, 500, (Sn, Cn)).astype(np.int32)
    for i in range(Sn):
        cand[i, rng.integers(10, Cn):] = -1
    session = np.arange(Sn, dtype=np.int64) + 1000
    labs = [[], [], []]
    for t in range(3):
        for i in range(0, Sn, 2 + t):    # leaves some sessions positive-free
            row = cand[i][cand[i] >= 0]
            for a in row[: 1 + (i % 3)]:
                labs[t].append((int(session[i]) << AID_BITS) | int(a))
    keys = tuple(torch.from_numpy(np.unique(np.asarray(ls, np.int64))) for ls in labs)
    ratio, cap = 3, 5
    cand_t, sess_t = torch.from_numpy(cand), torch.from_numpy(session)
    base = port_retrieval._label_bits_program(cand_t, sess_t, *keys).numpy()
    run = [port_retrieval._label_keep_bits_program(
        cand_t, sess_t, *keys, torch.Generator().manual_seed(7), ratio, cap).numpy()
        for _ in range(2)]
    bits = run[0]
    np.testing.assert_array_equal(bits, run[1])
    np.testing.assert_array_equal(bits & 7, base)
    with jax.enable_x64():
        ref_base = np.asarray(ref_retrieval._label_bits_program(
            jnp.asarray(cand), jnp.asarray(session), *(jnp.asarray(k.numpy()) for k in keys)))
    np.testing.assert_array_equal(base, ref_base)
    valid = cand >= 0
    for t in range(3):
        y = (base >> t) & 1
        keep = (bits >> (3 + t)) & 1
        assert not ((keep == 1) & ~valid).any()
        n_pos = ((y == 1) & valid).sum(1)
        has = n_pos > 0
        np.testing.assert_array_equal((keep == 1) & (y == 1), (y == 1) & valid & has[:, None])
        want = np.minimum(np.minimum(ratio * n_pos, cap), (valid & (y == 0)).sum(1)) * has
        np.testing.assert_array_equal(((keep == 1) & (y == 0)).sum(1), want)


def _selections(batches, bits, select, cfg):
    """Per type, every batch's selection through one rng (seeded 42)."""
    out = {}
    for tid in range(3):
        rng = np.random.default_rng(42)
        out[tid] = []
        for b, tb in zip(batches, bits):
            tgt = np.stack([(tb >> i) & 1 for i in range(3)], -1).astype(np.float32)
            out[tid].append(select(b, tgt, tid, cfg, rng))
    return out


def test_downsample_select_bit_equal_over_batches():
    ref_b, port_b, ref_l, labels = world()
    bits = [_ref_meta_bits(b, ref_l)[1] for b in ref_b]
    for b, tb in zip(port_b, bits):
        b.unpack_meta(_port_meta_bits(b, labels)[0])
    cfg = RankerConfig(neg_to_pos_ratio=2, max_neg_per_session=5)
    want = _selections(ref_b, bits, ref_rank.downsample_select,
                       RefRankerConfig(neg_to_pos_ratio=2, max_neg_per_session=5))
    got = _selections(port_b, bits, port_rank.downsample_select, cfg)
    assert want[2][2] is None and got[2][2] is None      # no positive: no draw
    n_rows = 0
    for tid in range(3):
        for g, w in zip(got[tid], want[tid]):
            if w is None:
                assert g is None
                continue
            for a, x in zip(g, w):
                np.testing.assert_array_equal(a, x)
            n_rows += len(g[0])
    assert n_rows > 1000


def test_downsample_rows_and_f16_bytes_equal():
    ref_b, port_b, ref_l, labels = world()
    cfg = RankerConfig()
    tg = [np.stack([(_ref_meta_bits(b, ref_l)[1] >> i) & 1 for i in range(3)], -1)
          .astype(np.float32) for b in ref_b]
    for tid in (0, 2):
        want = ref_rank.downsample(ref_b, tg, tid, RefRankerConfig())
        got = port_rank.downsample(port_b, tg, tid, cfg)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    si = np.array([0, 0, 3, 17, 200, 5])
    ci = np.array([0, 1, 2, 3, 4, 39])
    h_ref, n = ref_b[0].feats_rows_async(si, ci)
    h_port, n_port = port_b[0].feats_rows_async(si, ci)
    h_port = np.asarray(h_port)
    assert n == n_port == 6 and h_port.dtype == np.float16
    assert np.asarray(h_ref)[:n].tobytes() == h_port.tobytes()
    assert np.isfinite(h_port).all() and h_port[0, 4] == 65504.0
    np.testing.assert_array_equal(port_b[0].feats_rows(si, ci), ref_b[0].feats_rows(si, ci))


def test_device_source_eval_equals_reference_and_host():
    ref_b, port_b, ref_l, labels = world()
    dev = port_per_source.DeviceSourceEval(C, "cpu")
    want = ref_per_source.DeviceSourceEval(C)
    keys = port_retrieval.label_keys_device(labels, "cpu")
    ref_keys = ref_retrieval.label_keys_device(ref_l)
    for pb, rb in zip(port_b, ref_b):
        dev.update(*pb.pack_meta_labels(keys))
        want.update(*rb.pack_meta_labels(ref_keys))
    got = dev.finalize(labels)
    assert got == want.finalize(ref_l)
    assert port_per_source.format_report(got) == ref_per_source.format_report(got)
    assert 0 < got["_ceiling"]["total"]["topall"] < 1

    # otto_tpu's host report and ceiling on the same batches
    ceiling = got.pop("_ceiling")
    host = ref_per_source.eval_retrieved_by_source(ref_b, ref_l)
    for name, by_type in host.items():
        if name == "_counts":
            for s, stats in by_type.items():
                for k, v in stats.items():
                    assert abs(got["_counts"][s][k] - v) < 1e-9, (s, k)
            continue
        for tname, r in by_type.items():
            for k, v in r.items():
                assert abs(got[name][tname][k] - v) < 1e-12, (name, tname, k)
    want_ceiling = recall_at_k(np.concatenate([b.session for b in ref_b]),
                               np.concatenate([b.cand for b in ref_b]), ref_l)
    for tname, r in want_ceiling.items():
        for k, v in r.items():
            assert abs(ceiling[tname][k] - v) < 1e-12, (tname, k)


def test_pcg64_advance_is_the_draws_it_skips():
    """rng_at(seed, n): default_rng(seed) after n float64 draws, for draws
    in any shapes."""
    rng = np.random.default_rng(42)
    rng.random((3, 5))
    rng.random(7)
    np.testing.assert_array_equal(port_rank.rng_at(42, 22).random(9), rng.random(9))
    np.testing.assert_array_equal(port_rank.rng_at(42, 0).random(4),
                                  np.random.default_rng(42).random(4))


def test_draw_count_of_arrays_and_tensors():
    """draw_count, the downsampler's one has-a-positive rule: S * C draws
    where a valid candidate is a positive, none otherwise; the same on a
    numpy array and on a tensor (a 0-d int64 tensor on its device)."""
    pos = np.zeros((3, 5), bool)
    assert port_rank.draw_count(pos) == 0
    assert port_rank.draw_count(torch.from_numpy(pos)).item() == 0
    pos[2, 4] = True
    assert port_rank.draw_count(pos) == 15
    got = port_rank.draw_count(torch.from_numpy(pos))
    assert got.dtype == torch.int64 and got.item() == 15


@pytest.mark.parametrize("n_shares", [1, 2, 3])
def test_positioned_downsample_equals_sequential(n_shares):
    """pass A's positioning on N data ranks: rank r takes batches r, r + N,
    ...; each draws from the one-device stream moved to where its draws
    begin (draw_starts of every batch's draw_count: S * C where the batch
    has a positive of the type). The shares' rows, gathered and
    session-sorted, are otto_tpu's sequential `downsample` of all the
    batches, bit for bit, whatever order a share runs in."""
    ref_b, port_b, ref_l, labels = world()
    cfg = RankerConfig(neg_to_pos_ratio=2, max_neg_per_session=5)
    tg = [np.stack([(_ref_meta_bits(b, ref_l)[1] >> i) & 1 for i in range(3)], -1)
          .astype(np.float32) for b in ref_b]
    for tid in range(3):
        want = ref_rank.downsample(ref_b, tg, tid,
                                   RefRankerConfig(neg_to_pos_ratio=2, max_neg_per_session=5))
        counts = port_rank.draw_counts(port_b, tg, tid)
        begin = port_rank.draw_starts(counts)
        parts = []
        for r in range(n_shares):
            mine = list(range(r, len(port_b), n_shares))[::-1]
            parts.append(port_rank.downsample_parts(
                [port_b[i] for i in mine], [tg[i] for i in mine], tid, cfg,
                [begin[i] for i in mine]))
        got = port_rank.session_sorted(*(np.concatenate([p[k] for p in parts])
                                         for k in range(3)), tid)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert counts[2] == 0    # batch 2 has no order: no draws


class _Batches:
    """A retriever stand-in that yields fixed batches (all pass_a reads of
    a Retriever: its device, and iter_run), each with its index in the
    batch order as Retriever.iter_run gives it."""

    def __init__(self, batches):
        self.batches = batches
        for i, b in enumerate(batches):
            b.index = i
        self.ctx = type("Ctx", (), {"aid_emb": torch.zeros(1)})()

    def iter_run(self, test, batch_sessions):
        return iter(self.batches)


def test_pass_a_matches_reference_downsampling_and_eval(tmp_path):
    """pass_a over the batches: the persisted rows are otto_tpu's
    `downsample` of the same batches (per-type rngs, session-sorted), the
    reports are otto_tpu's DeviceSourceEval's."""
    ref_b, port_b, ref_l, labels = world()
    metrics, rep = port_runner.pass_a(_Batches(port_b), None, labels, RankerConfig(),
                                      str(tmp_path), skip_targets=("carts",))
    assert rep.sessions == sum(len(b.session) for b in ref_b) and rep.batches == N_BATCHES
    assert not (tmp_path / "downsampled-carts.npz").exists()
    keys = ref_retrieval.label_keys_device(ref_l)
    want_eval = ref_per_source.DeviceSourceEval(C)
    tg = []
    for b in ref_b:
        meta, bits = b.pack_meta_labels(keys)
        want_eval.update(meta, bits)
        bits = np.asarray(bits)
        tg.append(np.stack([(bits >> t) & 1 for t in range(3)], -1).astype(np.float32))
    report = want_eval.finalize(ref_l)
    ceiling = report.pop("_ceiling")
    assert json.loads((tmp_path / "eval_retrieved.json").read_text()) == \
        json.loads(json.dumps(ceiling))
    assert json.loads((tmp_path / "eval_retrieved_sources.json").read_text()) == \
        json.loads(json.dumps(report))
    assert metrics["ceiling_total"] == ceiling["total"]["topall"]
    assert metrics["cand_per_session_max"] == report["_counts"]["src_any"]["max"]
    for tname, tid in (("clicks", 0), ("orders", 2)):
        feats, y, sess = ref_rank.downsample(ref_b, tg, tid, RefRankerConfig())
        z = np.load(tmp_path / f"downsampled-{tname}.npz")
        assert z["feats"].tobytes() == feats.astype(np.float16).tobytes()
        np.testing.assert_array_equal(z["y"], y.astype(np.int8))
        np.testing.assert_array_equal(z["session"], sess)
        assert rep.rows[tname] == len(y) and rep.positive_sessions[tname] == len(np.unique(sess))


def test_pass_a_device_select_keeps_the_semantics(tmp_path):
    """RankerConfig.device_select: the keep bits come from the device
    (torch's generator): every positive of a session with one and
    min(ratio * n_pos, cap, available) of its negatives; the same eval."""
    _, port_b, _, labels = world()
    cfg = RankerConfig(neg_to_pos_ratio=2, max_neg_per_session=5, device_select=True)
    host_dir, dev_dir = tmp_path / "host", tmp_path / "device"
    host_dir.mkdir()
    dev_dir.mkdir()
    m_host, _ = port_runner.pass_a(_Batches(world()[1]), None, labels,
                                   RankerConfig(), str(host_dir))
    m_dev, rep = port_runner.pass_a(_Batches(port_b), None, labels, cfg, str(dev_dir))
    assert m_dev == m_host
    keys = port_retrieval.label_keys_device(labels, "cpu")
    n_sess = max(int(b.session.max()) for b in port_b) + 1
    for tname, tid in (("clicks", 0), ("carts", 1), ("orders", 2)):
        z = np.load(dev_dir / f"downsampled-{tname}.npz")
        got_pos = np.bincount(z["session"][z["y"] == 1], minlength=n_sess)
        got_neg = np.bincount(z["session"][z["y"] == 0], minlength=n_sess)
        for b in world()[1]:
            y = (b.pack_meta_labels(keys)[1].numpy() >> tid) & 1
            valid = b.cand >= 0
            n_pos = (y & valid).sum(1)
            want_neg = np.minimum(np.minimum(2 * n_pos, 5), (valid & (y == 0)).sum(1))
            np.testing.assert_array_equal(got_pos[b.session], n_pos)
            np.testing.assert_array_equal(got_neg[b.session], want_neg * (n_pos > 0))
        assert rep.rows[tname] == len(z["y"]) > 0
