"""K7 (ops/kernels/retrieval_features.py) on the CPU: Stage E's width-limited
transport sort, the kernel's contract with the Python side (its column,
stat and feature enums against COLUMNS, STATS and FEATURE_NAMES), the
wrapper's checks, and a CPU batch taking the twin. The kernel itself runs
only on the card (tests/test_torch_cuda.py)."""
import re

import numpy as np
import pytest
import torch

from otto_tpu_torch.data.batching import iter_microbatches, pack_sessions
from otto_tpu_torch.engine import retrieval
from otto_tpu_torch.engine.session_stats import SessionStats
from otto_tpu_torch.ops import segment as seg
from otto_tpu_torch.ops.kernels import _build
from otto_tpu_torch.ops.kernels import retrieval_features as k7
from test_torch_retrieval import BATCH, PORT_CFG, build_world
import torch_threads  # noqa: F401

SRC = _build.CSRC_DIR / "retrieval_features.cu"


def enum_names(name: str, prefix: str):
    """The enumerators of `enum <name>` in the kernel's source, prefix
    stripped, without the closing count."""
    body = re.search(r"enum " + name + r" : int \{(.*?)\};", SRC.read_text(), re.S).group(1)
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names[-1].startswith("N") and all(n.startswith(prefix) for n in names[:-1])
    return tuple(n[len(prefix):] for n in names[:-1])


@pytest.mark.parametrize("enum,prefix,want", [
    ("Column", "C_", k7.COLUMNS),
    ("Stat", "S_", k7.STATS),
    ("Feature", "F_", retrieval.FEATURE_NAMES),
])
def test_kernel_enums_match_the_python_lists(enum, prefix, want):
    assert enum_names(enum, prefix) == tuple(want)


def test_contract_names_exist():
    """The stats are SessionStats fields, the float columns are columns,
    and the kernel writes FEATURE_NAMES' width."""
    assert set(k7.STATS) <= set(SessionStats._fields)
    assert k7.FLOAT_COLUMNS <= set(k7.COLUMNS) and len(set(k7.COLUMNS)) == len(k7.COLUMNS)
    assert k7.N_FEATURES == len(retrieval.FEATURE_NAMES)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("width", ["below", "at", "above"])
def test_width_limited_transport_sort_keeps_the_first_lanes(dtype, width):
    """rowwise_transport_sort(width=C) equals the first min(C, W) lanes of
    the full sort, keys and columns, with rows of SENTINEL keys (empty
    rows, and SENTINEL tails) among them."""
    g = torch.Generator().manual_seed(3)
    S, W = 7, 40
    key = torch.randint(0, 12, (S, W), generator=g, dtype=torch.int32)
    key[1] = seg.SENTINEL
    key[2, 25:] = seg.SENTINEL
    cols = [torch.randint(-1000, 1000, (S, W), generator=g, dtype=torch.int32).to(dtype)
            for _ in range(3)]
    C = {"below": 13, "at": W, "above": W + 9}[width]
    ks_full, full = seg.rowwise_transport_sort(key, cols)
    ks, part = seg.rowwise_transport_sort(key, cols, width=C)
    n = min(C, W)
    assert ks.shape == (S, n) and all(p.shape == (S, n) and p.dtype == dtype for p in part)
    assert torch.equal(ks, ks_full[:, :n])
    for p, f in zip(part, full):
        assert torch.equal(p, f[:, :n])


def _args(S=3, C=5, D=4, A=9):
    cols = [torch.zeros((S, C), dtype=torch.float32 if n in k7.FLOAT_COLUMNS else torch.int32)
            for n in k7.COLUMNS]
    return dict(
        pk=torch.zeros((S, C), dtype=torch.int32), cols=cols,
        stats=[torch.zeros((S,), dtype=torch.int32) for _ in k7.STATS],
        pop_cl1_rank=torch.zeros((A, 6), dtype=torch.int32),
        aid_emb=torch.zeros((A, D), dtype=torch.float32),
        ses_emb=torch.zeros((S, D), dtype=torch.float32), max_candidates=C,
    )


def _col(a, name, fn):
    i = k7.COLUMNS.index(name)
    a["cols"][i] = fn(a["cols"][i])


BAD_CALLS = {
    "column_int64": (TypeError, "column n_aid is torch.int64",
                     lambda a: _col(a, "n_aid", lambda t: t.long())),
    "float_column_int32": (TypeError, "column w2v_all_sum_dist is torch.int32",
                           lambda a: _col(a, "w2v_all_sum_dist", lambda t: t.int())),
    "column_float32": (TypeError, "column cand is torch.float32",
                       lambda a: _col(a, "cand", lambda t: t.float())),
    "pk_int64": (TypeError, "pk is torch.int64", lambda a: a.update(pk=a["pk"].long())),
    "stat_float32": (TypeError, "stat max_ts is torch.float32",
                     lambda a: a["stats"].__setitem__(7, a["stats"][7].float())),
    "aid_emb_float64": (TypeError, "aid_emb is torch.float64",
                        lambda a: a.update(aid_emb=a["aid_emb"].double())),
    "pop_int64": (TypeError, "pop_cl1_rank is torch.int64",
                  lambda a: a.update(pop_cl1_rank=a["pop_cl1_rank"].long())),
    "pk_numpy": (TypeError, "pk is not a tensor", lambda a: a.update(pk=a["pk"].numpy())),
    "column_numpy": (TypeError, "is not a tensor",
                     lambda a: _col(a, "slf_n", lambda t: t.numpy())),
    "beyond_pointer_block": (ValueError, "pointer block takes 82",
                             lambda a: a["cols"].append(a["cols"][0])),
    "column_missing": (ValueError, "81 columns", lambda a: a["cols"].pop()),
    "stat_missing": (ValueError, "8 session stats", lambda a: a["stats"].pop()),
    "pk_1d": (ValueError, r"pk \(15,\)", lambda a: a.update(pk=a["pk"].reshape(-1))),
    "column_shape": (ValueError, "pop_present",
                     lambda a: _col(a, "pop_present", lambda t: t[:, :-1])),
    "stat_shape": (ValueError, "min_ts",
                   lambda a: a["stats"].__setitem__(8, a["stats"][8][:-1])),
    "pop_narrow": (ValueError, "K >= 3",
                   lambda a: a.update(pop_cl1_rank=a["pop_cl1_rank"][:, :2].contiguous())),
    "emb_widths": (ValueError, r"\[S, D\]",
                   lambda a: a.update(ses_emb=torch.zeros((3, 5), dtype=torch.float32))),
    "emb_too_wide": (ValueError, "D <= 1024", lambda a: a.update(
        aid_emb=torch.zeros((9, 1025)), ses_emb=torch.zeros((3, 1025)))),
    "no_aids": (ValueError, r"\[A, K >= 3\]", lambda a: a.update(
        pop_cl1_rank=torch.zeros((0, 6), dtype=torch.int32))),
    "cap_below_lanes": (ValueError, "max_candidates 4", lambda a: a.update(max_candidates=4)),
    "pk_strided": (ValueError, "pk's lanes",
                   lambda a: a.update(pk=torch.zeros((3, 10), dtype=torch.int32)[:, ::2])),
    "column_transposed": (ValueError, "slf_n is not contiguous", lambda a: _col(
        a, "slf_n", lambda t: torch.zeros((5, 3), dtype=torch.int32).t())),
    "emb_strided": (ValueError, "aid_emb is not contiguous",
                    lambda a: a.update(aid_emb=torch.zeros((9, 8))[:, ::2])),
    "two_devices": (ValueError, "more than one device",
                    lambda a: a.update(ses_emb=a["ses_emb"].to("meta"))),
    "cpu": (ValueError, "no kernel for cpu", lambda a: None),
}


@pytest.mark.parametrize("fault", sorted(BAD_CALLS))
def test_wrapper_refuses_what_the_kernel_does_not_take(fault):
    """A wrong dtype, shape, layout or device, or more columns than the
    kernel's pointer block, raise before any launch; CPU tensors go to the
    twin through retrieve_batch, never through the wrapper."""
    err, match, fault_fn = BAD_CALLS[fault]
    a = _args()
    fault_fn(a)
    before = k7.LAUNCHES.value
    with pytest.raises(err, match=match):
        k7.retrieval_features(**a)
    assert k7.LAUNCHES.value == before


def _first_batch(keep_aids, max_candidates):
    """retrieve_batch on the CPU over the parity world's first batch."""
    w = build_world()
    t = w["port_test"]
    port = w["port"]
    p = pack_sessions(t, PORT_CFG.session_len_buckets)[0]
    mb = next(iter_microbatches(p, min(BATCH, p.n_sessions)))
    cluster, semb = port.sessions.lookup(mb.session)
    trim = torch.tensor([PORT_CFG.trim_max_at_order_1, PORT_CFG.trim_min,
                         (PORT_CFG.trim_max_at_order_1 - PORT_CFG.trim_min)
                         / (PORT_CFG.trim_min_at_order - 1)], dtype=torch.float32)
    put = torch.from_numpy
    return retrieval.retrieve_batch(
        (put(mb.aid), put(mb.ts), put(mb.type)), port.ctx, put(cluster), put(semb), trim,
        keep_aids, max_candidates)


@pytest.mark.parametrize("cap", ["below", "above"])
def test_cpu_batch_takes_the_twin(monkeypatch, cap):
    """A CPU batch runs _features_program, once, and launches no K7; with
    a cap above the lanes kept the slots past them are padding (cand -1,
    ts_order 999, features 0)."""
    calls = []
    twin = retrieval._features_program

    def spy(pk, *args):
        calls.append(pk.shape)
        return twin(pk, *args)

    monkeypatch.setattr(retrieval, "_features_program", spy)
    before = k7.LAUNCHES.value
    cap_n = {"below": 24, "above": 4096}[cap]
    cand, feats, ts = _first_batch(4, cap_n)
    assert k7.LAUNCHES.value == before
    assert len(calls) == 1
    S, C = calls[0]
    assert cand.shape == ts.shape == (S, cap_n) and feats.shape == (S, cap_n, k7.N_FEATURES)
    assert C == cap_n if cap == "below" else C < cap_n
    assert bool((cand[:, :C] >= 0).any())
    if cap == "above":
        assert bool((cand[:, C:] == -1).all()) and bool((ts[:, C:] == 999).all())
        assert bool((feats[:, C:] == 0).all())
    np.testing.assert_array_equal(
        feats[..., retrieval.FEATURE_INDEX["src_any"]].numpy(), (cand >= 0).float().numpy())
