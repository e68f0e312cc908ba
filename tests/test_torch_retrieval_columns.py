"""K8 (ops/kernels/retrieval_columns.py) on the CPU: the kernel's contract
with the Python side (its input, column and group enums against INPUTS,
COLUMNS and GROUPS), the columns against what Stage E reads and what the
twin builds, the wrapper's checks, and a CPU batch taking the twin. The
kernels themselves run only on the card (tests/test_torch_cuda.py)."""
import re

import pytest
import torch

from otto_tpu_torch.engine import retrieval
from otto_tpu_torch.ops import segment as seg
from otto_tpu_torch.ops.kernels import _build
from otto_tpu_torch.ops.kernels import retrieval_columns as k8
from otto_tpu_torch.ops.kernels import retrieval_features as k7
from test_torch_retrieval_features import _first_batch
import torch_threads  # noqa: F401

SRC = _build.CSRC_DIR / "retrieval_columns.cu"
GROUP_NAMES = tuple(f"{str(dtype).rsplit('.', 1)[1]}_{red}" for dtype, red, _ in k8.GROUPS)


def enum_names(name: str, prefix: str):
    """The enumerators of `enum <name>` in the kernel's source, prefix
    stripped, without the closing count."""
    body = re.search(r"enum " + name + r" : int \{(.*?)\};", SRC.read_text(), re.S).group(1)
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names[-1].startswith("N") and all(n.startswith(prefix) for n in names[:-1])
    return tuple(n[len(prefix):] for n in names[:-1])


@pytest.mark.parametrize("enum,prefix,want", [
    ("Input", "I_", k8.INPUTS),
    ("Column", "C_", k8.COLUMNS),
    ("Group", "G_", GROUP_NAMES),
])
def test_kernel_enums_match_the_python_lists(enum, prefix, want):
    assert enum_names(enum, prefix) == tuple(want)


def test_kernel_groups_start_where_the_python_groups_do():
    """GROUP_FIRST in the source names each group's first column, in
    GROUPS order, then NCOLS: the kernel's identities follow them."""
    line = re.search(r"GROUP_FIRST\[NGROUPS \+ 1\] = \{(.*?)\};", SRC.read_text(), re.S).group(1)
    firsts = [n.strip() for n in line.split(",")]
    assert firsts == [f"C_{names[0]}" for _, _, names in k8.GROUPS] + ["NCOLS"]


def test_columns_are_what_stage_e_reads():
    """K8 writes exactly the columns Stage E reads: the Stage D reductions
    K7's launch takes, and ts_order_aid for the compaction's priority.
    Nothing else (the co-visitation best ranks nothing reads are gone)."""
    read = set(k7.COLUMNS[2:]) | {"ts_order_aid"}
    assert len(set(k8.COLUMNS)) == len(k8.COLUMNS)
    assert set(k8.COLUMNS) == read
    assert not any(n.startswith("cov") and n.endswith("best_rank") for n in k8.COLUMNS)
    floats = {n for n, (dtype, _) in k8.REDUCERS.items() if dtype == torch.float32}
    assert floats == k7.FLOAT_COLUMNS


@pytest.fixture(scope="module")
def twin_call():
    """The arguments and outputs of _columns_program on the parity world's
    first batch (CPU): (args, (key2, columns))."""
    calls = []
    twin = retrieval._columns_program

    def spy(*args):
        out = twin(*args)
        calls.append((args, out))
        return out

    retrieval._columns_program = spy
    try:
        _first_batch(16, 64)
    finally:
        retrieval._columns_program = twin
    assert len(calls) == 1
    return calls[0]


def test_twin_builds_the_kernels_columns(twin_call):
    """The twin's columns are K8's, group by group in GROUPS order (the
    order rowwise_groupby_scan stacks them for K2), with K8's dtypes and
    reducers; its level-1 inputs are INPUTS; key2 holds the level-1 lanes
    then the popularity slots."""
    (ks1, red1, end1, min_ts, cluster, ctx, trim), (key2, cols) = twin_call
    assert set(red1) == set(k8.INPUTS)
    for n in k8.INPUTS:
        want = torch.float32 if n in k8.FLOAT_INPUTS else torch.int32
        assert red1[n].dtype == want and red1[n].shape == ks1.shape, n
    grouped = {}
    for n, (col, red) in cols.items():
        grouped.setdefault((col.dtype, red), []).append(n)
    assert [(dtype, red, tuple(names)) for (dtype, red), names in grouped.items()] \
        == list(k8.GROUPS)
    S, P1 = ks1.shape
    assert key2.shape == (S, P1 + ctx.pop_cl50_cand.shape[1]) and key2.dtype == torch.int32
    assert all(col.shape == key2.shape for col, _ in cols.values())
    assert bool((key2[:, :P1] != seg.SENTINEL).any()) and bool((key2[:, P1:] != seg.SENTINEL).any())


def _inputs(S, P1):
    return [torch.zeros((S, P1), dtype=torch.float32 if n in k8.FLOAT_INPUTS else torch.int32)
            for n in k8.INPUTS]


def _key_args(S=3, P1=5, T=4, n_cl=2, K=6):
    i32 = torch.int32
    return dict(ks1=torch.zeros((S, P1), dtype=i32), end1=torch.zeros((S, P1), dtype=torch.bool),
                inputs=_inputs(S, P1), trim_params=torch.zeros(3),
                cluster=torch.zeros(S, dtype=i32), pop_cand=torch.zeros((n_cl, T), dtype=i32),
                pop_ranks=torch.zeros((n_cl, T, K), dtype=i32))


def _column_args(S=3, P1=5, T=4, n_cl=2, K=6):
    i32 = torch.int32
    return dict(ks2=torch.zeros((S, P1 + T), dtype=i32),
                perm=torch.zeros((S, P1 + T), dtype=torch.int64),
                flags=torch.zeros((S, P1), dtype=torch.uint8), inputs=_inputs(S, P1),
                min_ts=torch.zeros(S, dtype=i32), cluster=torch.zeros(S, dtype=i32),
                pop_ranks=torch.zeros((n_cl, T, K), dtype=i32))


def _input(a, name, fn):
    i = k8.INPUTS.index(name)
    a["inputs"][i] = fn(a["inputs"][i])


# fault: (launch, error, message, change to the arguments)
BAD_CALLS = {
    "keys_input_int64": ("keys", TypeError, "input sa_n_aid is torch.int64",
                         lambda a: _input(a, "sa_n_aid", lambda t: t.long())),
    "keys_float_input_int32": ("keys", TypeError, "input w2v_all_dist is torch.int32",
                               lambda a: _input(a, "w2v_all_dist", lambda t: t.int())),
    "keys_ks1_int64": ("keys", TypeError, "ks1 is torch.int64",
                       lambda a: a.update(ks1=a["ks1"].long())),
    "keys_ks1_numpy": ("keys", TypeError, "ks1 is not a tensor",
                       lambda a: a.update(ks1=a["ks1"].numpy())),
    "keys_end1_uint8": ("keys", TypeError, "end1 is torch.uint8",
                        lambda a: a.update(end1=a["end1"].to(torch.uint8))),
    "keys_trim_float64": ("keys", TypeError, "trim_params is torch.float64",
                          lambda a: a.update(trim_params=a["trim_params"].double())),
    "keys_ks1_1d": ("keys", ValueError, r"ks1 \(15,\)",
                    lambda a: a.update(ks1=a["ks1"].reshape(-1))),
    "keys_trim_shape": ("keys", ValueError, r"trim_params \(4,\)",
                        lambda a: a.update(trim_params=torch.zeros(4))),
    "keys_cluster_rows": ("keys", ValueError, r"cluster \(4,\)",
                          lambda a: a.update(cluster=torch.zeros(4, dtype=torch.int32))),
    "keys_input_shape": ("keys", ValueError, "input cov0_rank",
                         lambda a: _input(a, "cov0_rank", lambda t: t[:, :-1])),
    "keys_beyond_pointer_block": ("keys", ValueError, "pointer block takes 48",
                                  lambda a: a["inputs"].append(a["inputs"][0])),
    "keys_input_missing": ("keys", ValueError, "47 level-1 columns",
                           lambda a: a["inputs"].pop()),
    "keys_pop_narrow": ("keys", ValueError, "K >= 6", lambda a: a.update(
        pop_ranks=a["pop_ranks"][:, :, :5].contiguous())),
    "keys_no_clusters": ("keys", ValueError, "n_cl >= 1", lambda a: a.update(
        pop_cand=torch.zeros((0, 4), dtype=torch.int32),
        pop_ranks=torch.zeros((0, 4, 6), dtype=torch.int32))),
    "keys_pop_tables_disagree": ("keys", ValueError, r"pop_cand \(2, 3\)", lambda a: a.update(
        pop_cand=torch.zeros((2, 3), dtype=torch.int32))),
    "keys_input_strided": ("keys", ValueError, "sa_src is not contiguous", lambda a: _input(
        a, "sa_src", lambda t: torch.zeros((5, 3), dtype=torch.int32).t())),
    "keys_two_devices": ("keys", ValueError, "more than one device",
                         lambda a: a.update(trim_params=a["trim_params"].to("meta"))),
    "keys_cpu": ("keys", ValueError, "no kernel for cpu", lambda a: None),
    "columns_perm_int32": ("columns", TypeError, "perm is torch.int32",
                           lambda a: a.update(perm=a["perm"].int())),
    "columns_flags_bool": ("columns", TypeError, "flags is torch.bool",
                           lambda a: a.update(flags=a["flags"].bool())),
    "columns_min_ts_float32": ("columns", TypeError, "min_ts is torch.float32",
                               lambda a: a.update(min_ts=a["min_ts"].float())),
    "columns_float_input_int32": ("columns", TypeError, "input w2v_12_dist is torch.int32",
                                  lambda a: _input(a, "w2v_12_dist", lambda t: t.int())),
    "columns_lanes": ("columns", ValueError, "8 sorted lanes", lambda a: a.update(
        ks2=a["ks2"][:, :8].contiguous(), perm=a["perm"][:, :8].contiguous())),
    "columns_flags_rows": ("columns", ValueError, r"are not \[S, P2\] and \[S, P1\]",
                           lambda a: a.update(flags=a["flags"][:2])),
    "columns_perm_shape": ("columns", ValueError, r"perm \(3, 8\)",
                           lambda a: a.update(perm=a["perm"][:, :8])),
    "columns_input_shape": ("columns", ValueError, "input sa_src",
                            lambda a: _input(a, "sa_src", lambda t: t[:, :-1])),
    "columns_beyond_pointer_block": ("columns", ValueError, "pointer block takes 48",
                                     lambda a: a["inputs"].append(a["inputs"][0])),
    "columns_pop_narrow": ("columns", ValueError, "K >= 6", lambda a: a.update(
        pop_ranks=a["pop_ranks"][:, :, :5].contiguous())),
    "columns_ks2_strided": ("columns", ValueError, "ks2 is not contiguous", lambda a: a.update(
        ks2=torch.zeros((9, 3), dtype=torch.int32).t())),
    "columns_two_devices": ("columns", ValueError, "more than one device",
                            lambda a: a.update(min_ts=a["min_ts"].to("meta"))),
    "columns_cpu": ("columns", ValueError, "no kernel for cpu", lambda a: None),
}


@pytest.mark.parametrize("fault", sorted(BAD_CALLS))
def test_wrapper_refuses_what_the_kernel_does_not_take(fault):
    """A wrong dtype, shape, layout or device, mismatched S or lanes, or
    more level-1 columns than the kernel's pointer block, raise before any
    launch; CPU tensors go to the twin through retrieve_batch, never
    through the wrapper."""
    launch, err, match, fault_fn = BAD_CALLS[fault]
    a = _key_args() if launch == "keys" else _column_args()
    fault_fn(a)
    fn = k8.retrieval_keys if launch == "keys" else k8.retrieval_columns
    before = k8.LAUNCHES.value
    with pytest.raises(err, match=match):
        fn(**a)
    assert k8.LAUNCHES.value == before


def _grouped_stage_d(ks1, red1, end1, min_ts, cluster, ctx, trim_params):
    """Stage D as the card lays it out, on the CPU: the twin's key sort, its
    columns moved to sort order and stacked by GROUPS, each group scanned
    as one tensor from segment flags of the sorted keys."""
    key2, cols = retrieval._columns_program(ks1, red1, end1, min_ts, cluster, ctx, trim_params)
    ks2, perm = torch.sort(key2, dim=-1, stable=True)
    first = ks2 != seg._prev(ks2, seg.NEG_SENTINEL)
    is_end = seg._next(first, True) & (ks2 != seg.SENTINEL)
    red2 = {}
    for _, red, names in k8.GROUPS:
        g = torch.stack([torch.gather(cols[n][0], 1, perm) for n in names])
        red2.update(zip(names, seg.segmented_scan(g, first, red)))
    return ks2, red2, is_end


def test_cpu_batch_takes_the_twin(monkeypatch):
    """A CPU batch runs _columns_program once and launches no K8, and its
    output is byte-equal to that of the card's layout (the columns in sort
    order, grouped by GROUPS, one scan a group) run on the CPU."""
    calls = []
    twin = retrieval._columns_program
    monkeypatch.setattr(retrieval, "_columns_program", lambda *a: calls.append(1) or twin(*a))
    before = k8.LAUNCHES.value
    got = _first_batch(16, 64)
    assert k8.LAUNCHES.value == before and len(calls) == 1
    monkeypatch.setattr(retrieval, "_stage_d", _grouped_stage_d)
    want = _first_batch(16, 64)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert bool((got[0] >= 0).any())
