"""The frozen copies under benchmark/gen/ and benchmark/reference/ give
what the port gives at a tiny size on the CPU (the port's code at commit
7f160d3, from which they were copied)."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.gen import rankers as gen_rankers
from benchmark.gen import tables as gen_tables
from benchmark.gen.sessions import SyntheticSpec, generate_device, session_stream
from benchmark.reference import batching as ref_batching
from benchmark.reference import rank as ref_rank
from benchmark.reference import retrieval as ref_retrieval
from benchmark.reference import twins
from benchmark.reference.check import trim_params
from benchmark.tests.bench_tiny import tiny

CPU = torch.device("cpu")
SPEC = SyntheticSpec(n_sessions=300, n_aids=2000, max_len=128, mean_len=13.4, seed=12345)


def test_generator_equals_the_ports():
    from otto_tpu_torch.data.synthetic import SyntheticSpec as PortSpec
    from otto_tpu_torch.data.synthetic import generate_device as port_generate

    mine = generate_device(SPEC, CPU)
    port = port_generate(PortSpec(**SPEC.__dict__), CPU)
    for name in ("session", "aid", "ts", "type"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(port, name))


def test_stream_is_cut_prefixes_of_seed_free_sizes():
    s = session_stream(SPEC, 99, CPU)
    other = session_stream(SyntheticSpec(**dict(SPEC.__dict__, seed=777)), 99, CPU)
    # the sizes come from the shape seed alone, the contents from the spec's seed
    np.testing.assert_array_equal(s.starts, other.starts)
    assert not np.array_equal(s.aid, other.aid)
    g = torch.Generator().manual_seed(99)
    full_len = torch.empty(SPEC.n_sessions, dtype=torch.float64).log_normal_(
        np.log(SPEC.mean_len), 0.7, generator=g).to(torch.int64).clamp(2, SPEC.max_len)
    full = generate_device(SPEC, CPU, lengths=full_len)
    lens = np.bincount(full.session, minlength=SPEC.n_sessions)
    np.testing.assert_array_equal(lens, full_len.numpy())
    cut = s.lengths()
    assert (cut >= 1).all() and (cut <= lens - 1).all()
    st = np.concatenate([[0], np.cumsum(lens)])
    for i in (0, 7, 299):
        np.testing.assert_array_equal(s.aid[s.starts[i]:s.starts[i + 1]],
                                      full.aid[st[i]:st[i] + cut[i]])


def test_batching_equals_the_ports():
    from otto_tpu_torch.data.batching import iter_microbatches, pack_sessions
    from otto_tpu_torch.data.schema import Events

    s = session_stream(SPEC, 1, CPU)
    cols = (s.session, s.aid, s.ts, s.type)
    mine = [b for p in ref_batching.pack_sessions(*cols) for b in
            ref_batching.iter_microbatches(p, 64)]
    port = [b for p in pack_sessions(Events(*cols)) for b in iter_microbatches(p, 64)]
    assert len(mine) == len(port)
    for a, b in zip(mine, port):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def _inputs():
    spec, cfg, traffic = tiny("gbdt-passb", n_trees=30)
    stream = session_stream(SPEC, 5, CPU)
    g = torch.Generator().manual_seed(8)
    ctx = gen_tables.retrieval_context(stream, cfg, g)
    sess = gen_tables.session_tables(stream, ctx.aid_emb, 50, g)
    return cfg, stream, ctx, sess


def test_twins_equal_the_ports():
    from otto_tpu_torch.ops.kernels.gather import gather_rows_ref
    from otto_tpu_torch.ops.kernels.segscan import segmented_scan_ref

    g = torch.Generator().manual_seed(3)
    v = torch.randint(-50, 50, (3, 16, 40), generator=g, dtype=torch.int32)
    idx = torch.randint(0, 40, (16, 25), generator=g, dtype=torch.int32)
    first = torch.rand((16, 40), generator=g) < 0.3
    assert torch.equal(twins.gather_rows_ref(v, idx), gather_rows_ref(v, idx))
    for red in ("sum", "min", "max"):
        assert torch.equal(twins.segmented_scan_ref(v, first, red),
                           segmented_scan_ref(v, first, red))
        vf = v.to(torch.float32) * 0.37
        assert torch.equal(twins.segmented_scan_ref(vf, first, red),
                           segmented_scan_ref(vf, first, red))


def test_retrieval_equals_the_ports():
    from otto_tpu_torch.engine.covis import CoVisTables
    from otto_tpu_torch.engine.retrieval import RetrievalContext, retrieve_batch

    cfg, stream, ctx, sess = _inputs()
    port_ctx = RetrievalContext(covis=tuple(CoVisTables(*t) for t in ctx.covis),
                                knn_all=ctx.knn_all, knn_1_2=ctx.knn_1_2,
                                pop_cl50_cand=ctx.pop_cl50_cand,
                                pop_cl50_ranks=ctx.pop_cl50_ranks,
                                pop_cl1_rank=ctx.pop_cl1_rank, aid_emb=ctx.aid_emb)
    rc = cfg["retrieval"]
    trim = trim_params(rc, CPU)
    cols = (stream.session, stream.aid, stream.ts, stream.type)
    n_checked = 0
    for p in ref_batching.pack_sessions(*cols, bucket_lens=rc["session_len_buckets"]):
        mb = next(ref_batching.iter_microbatches(p, 64))
        args = ((torch.from_numpy(mb.aid), torch.from_numpy(mb.ts), torch.from_numpy(mb.type)),)
        cl = torch.from_numpy(sess.cluster[np.maximum(mb.session, 0)])
        em = torch.from_numpy(sess.emb[np.maximum(mb.session, 0)])
        want = retrieve_batch(*args, port_ctx, cl, em, trim, rc["max_session_aids"],
                              rc["max_candidates"])
        got = ref_retrieval.retrieve_batch(*args, ctx, cl, em, trim, rc["max_session_aids"],
                                           rc["max_candidates"])
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert (got[0] >= 0).any()
        n_checked += 1
    assert n_checked >= 2


def test_rankers_equal_the_ports():
    from otto_tpu_torch.config import GBDTConfig, RankerConfig
    from otto_tpu_torch.engine.rank import _topk_program
    from otto_tpu_torch.engine.retrieval import FEATURE_NAMES
    from otto_tpu_torch.models.gbdt import GBDTRanker
    from otto_tpu_torch.models.ranker import Ranker, RankerTower

    g = torch.Generator().manual_seed(4)
    F = len(FEATURE_NAMES)
    feats = torch.where(torch.rand((40, 16, F), generator=g) < 0.5,
                        torch.randint(-1, 30, (40, 16, F), generator=g).float(),
                        torch.rand((40, 16, F), generator=g) * 1e5)
    ga = gen_rankers.gbdt_arrays(F, 150, 4, 64, g)
    port = GBDTRanker(GBDTConfig(), ga["edges"], ga["gfeat"], ga["thr"], ga["leaf"],
                      FEATURE_NAMES)
    want = port.predict_scores_device(feats)
    got = ref_rank.gbdt_scores(feats.reshape(-1, F), ga).reshape(40, 16)
    assert torch.equal(got, want)
    ma = gen_rankers.mlp_arrays(F, [256, 128, 64], g)
    port = Ranker(RankerConfig(), RankerTower(ma["norm_mean"], ma["norm_std"], ma["weights"]),
                  FEATURE_NAMES)
    want = port.predict_scores_device(feats)
    got = ref_rank.mlp_scores(feats.reshape(-1, F), ma).reshape(40, 16)
    assert torch.equal(got, want)
    cand = torch.randint(-1, 100, (40, 16), generator=g, dtype=torch.int32)
    for a, b in zip(ref_rank.topk(want, cand, 5), _topk_program(want, cand, 5)):
        assert torch.equal(a, b)
