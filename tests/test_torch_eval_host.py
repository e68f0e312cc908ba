"""The host-side C14 / C19 evaluators of the port against otto_tpu's:
recall_at_k, evaluate_topk, evaluate_submission_file and the per-source
report eval_retrieved_by_source (mirroring test_eval.py,
test_submission_eval.py and test_aux.py::test_per_source_eval_smoke);
and the host report against the port's own DeviceSourceEval on the same
batches. Recall values are exact (the same numpy arithmetic); the host
and device reports agree within 1e-9 (weighted totals)."""
import numpy as np
import pytest
import torch

from otto_tpu.data.schema import Labels as RefLabels
from otto_tpu.engine.rank import write_submission as ref_write_submission
from otto_tpu.engine.retrieval import FEATURE_INDEX as REF_FEATURE_INDEX
from otto_tpu.engine.retrieval import F_TOTAL
from otto_tpu.engine.retrieval import RetrievedBatch as RefBatch
from otto_tpu.eval import per_source as ref_per_source
from otto_tpu.eval import recall as ref_recall
from otto_tpu_torch.data.schema import Labels
from otto_tpu_torch.engine import rank
from otto_tpu_torch.engine.retrieval import FEATURE_INDEX, RetrievedBatch, label_keys_device
from otto_tpu_torch.eval import per_source, recall

TYPES = ("clicks", "carts", "orders")


def both_labels(session, type_, aid):
    return (Labels(np.array(session), np.array(type_), np.array(aid)),
            RefLabels(np.array(session), np.array(type_), np.array(aid)))


@pytest.mark.parametrize("case", ["basic", "truth_cap", "no_prediction"])
def test_evaluate_topk_cases(case):
    """test_eval.py's hand-computed cases, on both packages."""
    if case == "basic":
        lab, ref = both_labels([1, 2, 1, 1], [0, 0, 1, 1], [5, 7, 11, 12])
        sessions = np.array([1, 2], np.int32)
        aids = np.full((2, 20), -1, np.int32)
        aids[0, :2], aids[1, 0] = (5, 11), 99
        want = {"clicks": 0.5, "carts": 0.5, "orders": 0.0}
    elif case == "truth_cap":
        lab, ref = both_labels(np.full(30, 1), np.full(30, 2), np.arange(30))
        sessions, aids = np.array([1], np.int32), np.arange(20, dtype=np.int32)[None, :]
        want = {"orders": 1.0}
    else:
        lab, ref = both_labels([1, 2], [0, 0], [5, 6])
        sessions = np.array([1], np.int32)
        aids = np.full((1, 20), -1, np.int32)
        aids[0, 0] = 5
        want = {"clicks": 0.5}
    preds = {t: (sessions, aids) for t in TYPES}
    got = recall.evaluate_topk(preds, lab)
    assert got == ref_recall.evaluate_topk(preds, ref)
    for k, v in want.items():
        assert got[k] == v


def test_recall_at_k_cutoffs_and_random_sets():
    lab, ref = both_labels([1], [0], [42])
    aids = np.full((1, 300), -1, np.int32)
    aids[0, 150] = 42
    got = recall.recall_at_k(np.array([1], np.int32), aids, lab)
    assert got == ref_recall.recall_at_k(np.array([1], np.int32), aids, ref)
    assert [got["clicks"][k] for k in ("top20", "top100", "top200", "topall")] == \
        [0.0, 0.0, 1.0, 1.0]

    rng = np.random.default_rng(3)
    S, C = 500, 256
    sessions = rng.permutation(2000)[:S].astype(np.int32)
    cand = np.stack([rng.permutation(5000)[:C] for _ in range(S)]).astype(np.int32)
    cand[rng.random((S, C)) < 0.3] = -1
    r = rng.integers(0, S, 1500)
    la = np.where(rng.random(1500) < 0.5, cand[r, rng.integers(0, C, 1500)],
                  rng.integers(0, 5000, 1500))
    lab, ref = both_labels(sessions[r], rng.integers(0, 3, 1500), la)
    got = recall.recall_at_k(sessions, cand, lab, cutoffs=(20, 100, 200))
    assert got == ref_recall.recall_at_k(sessions, cand, ref, cutoffs=(20, 100, 200))
    assert 0 < got["total"]["topall"] < 1


def test_submission_file_eval_matches_reference(tmp_path):
    """test_submission_eval.py: the port writes the CSV, both packages
    re-parse and score it alike, and the port reads otto_tpu's CSV."""
    sessions = np.array([3, 1], np.int32)
    aids = np.array([[5, 7, -1], [9, -1, -1]], np.int32)
    preds = {t: (sessions, aids) for t in TYPES}
    lab, ref = both_labels([3, 1], [0, 2], [7, 9])
    path = str(tmp_path / "sub.csv")
    rank.write_submission(path, preds)
    got = recall.evaluate_submission_file(path, lab)
    assert got == ref_recall.evaluate_submission_file(path, ref)
    assert abs(got["total"] - recall.evaluate_topk(preds, lab)["total"]) < 1e-12
    assert got["clicks"] == got["orders"] == 1.0
    ref_path = str(tmp_path / "ref.csv")
    ref_write_submission(ref_path, preds)
    assert recall.evaluate_submission_file(ref_path, lab) == got


def _batches(rng, n_batches=3, S=200, C=64):
    """Port and otto_tpu batches with the same candidates (unique in a row,
    -1 pads) and random source flags; labels hitting some candidates."""
    port, ref, all_s, all_c = [], [], [], []
    for i in range(n_batches):
        session = (np.arange(S) + i * S).astype(np.int32)
        cand = np.stack([rng.permutation(4000)[:C] for _ in range(S)]).astype(np.int32)
        cand[:, C // 2:][rng.random((S, C - C // 2)) < 0.5] = -1
        feats = np.zeros((S, C, F_TOTAL), np.float32)
        for name in per_source.SOURCES:
            assert FEATURE_INDEX[name] == REF_FEATURE_INDEX[name]
            feats[:, :, FEATURE_INDEX[name]] = rng.random((S, C)) < 0.4
        feats[:, :, FEATURE_INDEX["src_any"]] = cand >= 0
        feats[cand < 0] = 0
        port.append(RetrievedBatch(session, torch.from_numpy(cand), torch.from_numpy(feats),
                                   torch.from_numpy(cand)))
        ref.append(RefBatch(session=session, cand=cand, feats=feats,
                            ts_order=np.zeros((S, C), np.int32)))
        all_s.append(session)
        all_c.append(cand)
    s, c = np.concatenate(all_s), np.concatenate(all_c)
    hit = (rng.random(c.shape) < 0.03) & (c >= 0)
    si, ci = np.nonzero(hit)
    ls = np.concatenate([s[si], rng.choice(s, 300)])
    la = np.concatenate([c[si, ci], rng.integers(0, 4000, 300)])
    lt = rng.integers(0, 3, len(ls))
    key = np.unique(np.stack([ls, lt, la], 1), axis=0)     # one label per (s, t, aid)
    return port, ref, key


def test_per_source_smoke_matches_reference():
    """test_aux.py::test_per_source_eval_smoke on both packages."""
    S, C = 2, 4
    cand = np.array([[5, 7, -1, -1], [9, -1, -1, -1]], np.int32)
    feats = np.zeros((S, C, F_TOTAL), np.float32)
    feats[:, :, FEATURE_INDEX["src_any"]] = cand >= 0
    feats[0, 0, FEATURE_INDEX["src_self"]] = 1
    feats[0, 1, FEATURE_INDEX["src_click_to_click"]] = 1
    session = np.array([1, 2], np.int32)
    lab, ref = both_labels([1], [0], [7])
    got = per_source.eval_retrieved_by_source(
        [RetrievedBatch(session, torch.from_numpy(cand), torch.from_numpy(feats),
                        torch.from_numpy(cand))], lab)
    want = ref_per_source.eval_retrieved_by_source(
        [RefBatch(session=session, cand=cand, feats=feats, ts_order=np.zeros((S, C), np.int32))],
        ref)
    assert got == want
    assert got["src_click_to_click & not self"]["clicks"]["topall"] == 1.0
    assert got["src_self"]["clicks"]["topall"] == 0.0
    assert "src_any" in per_source.format_report(got)


def test_per_source_report_matches_reference_and_device_eval():
    """Random batches: the port's host report (flags packed to uint16 on the
    batch's device) equals otto_tpu's exactly, and the port's
    DeviceSourceEval on the same batches within 1e-9; its ceiling is
    recall_at_k of every candidate."""
    rng = np.random.default_rng(5)
    port, ref, key = _batches(rng)
    lab, ref_lab = both_labels(key[:, 0], key[:, 1], key[:, 2])
    packed = per_source.SrcFlagBatch.from_batch(port[0])
    assert packed.flags.dtype == np.uint16 and packed.flags.shape == port[0].cand.shape
    got = per_source.eval_retrieved_by_source(port, lab)
    assert got == ref_per_source.eval_retrieved_by_source(ref, ref_lab)
    assert got == per_source.eval_retrieved_by_source(
        [per_source.SrcFlagBatch.from_batch(b) for b in port], lab)

    dev = per_source.DeviceSourceEval(port[0].cand.shape[1], "cpu")
    keys = label_keys_device(lab, "cpu")
    for b in port:
        dev.update(*b.pack_meta_labels(keys))
    want = dev.finalize(lab)
    ceiling = want.pop("_ceiling")

    def close(x, y):
        if isinstance(x, dict):
            assert set(x) == set(y)
            for k in x:
                close(x[k], y[k])
        else:
            assert abs(x - y) <= 1e-9, (x, y)

    close(got, want)
    close(recall.recall_at_k(np.concatenate([b.session for b in port]),
                             np.concatenate([b.cand for b in port]), lab), ceiling)
    assert 0 < ceiling["total"]["topall"] < 1


def test_join_labels_and_session_lookup_match_reference():
    """The batch runner's host label join and SessionLookup.from_dicts."""
    from otto_tpu.engine import retrieval as ref_retrieval
    from otto_tpu_torch.engine import retrieval

    rng = np.random.default_rng(8)
    port, ref, key = _batches(rng)
    lab, ref_lab = both_labels(key[:, 0], key[:, 1], key[:, 2])
    got, want = retrieval.join_labels(port, lab), ref_retrieval.join_labels(ref, ref_lab)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert 0 < sum(float(g.sum()) for g in got)

    cluster = {3: 7, 9: 1, 4: 2}
    emb = {9: np.arange(4, dtype=np.float32), 5: np.ones(4, np.float32)}
    a = retrieval.SessionLookup.from_dicts(cluster, emb, 4)
    b = ref_retrieval.SessionLookup.from_dicts(cluster, emb, 4)
    q = np.array([9, 3, 5, 100, 4], np.int32)
    for x, y in zip(a.lookup(q), b.lookup(q)):
        np.testing.assert_array_equal(x, y)
    assert len(retrieval.SessionLookup.from_dicts({}, {}, 4).lookup(q)[1]) == len(q)
