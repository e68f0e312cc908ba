"""K8: retrieval's Stage D, the level-2 groupby's columns, in two launches.

`retrieval_keys` reads the level-1 groupby's outputs, ks1 [S, P1] int32
sorted keys, end1 [S, P1] bool segment ends and its reductions [S, P1] in
INPUTS order (int32 but for the two float32 w2vec distances), with the
trim parameters [3] float32 (max_at_1, min_n, delta), the sessions' cl50
cluster [S] int32 and the popularity tables pop_cand [n_cl, T] and
pop_ranks [n_cl, T, K >= 6] int32, and writes key2 [S, P1 + T] int32 (the
entries the recency-adaptive trim keeps, then the cluster's popularity
candidates within rank 20, SENTINEL elsewhere) and one flag byte a level-1
lane (bit 0 kept, bit 1 the session's own aid). After
`torch.sort(key2, stable=True)`, `retrieval_columns` writes every column
the scans and Stage E read in sort order, grouped by (dtype, reducer) as
GROUPS lists them, each group one [G, S, P2] tensor for K2 to scan as it
lies, and the segment flags first and is_end [S, P2] bool of the sorted
keys.

The CUDA kernels are `otto_tpu_torch/csrc/retrieval_columns.cu`; their
plain twin is `engine/retrieval.py::_columns_program` (with the groupby of
`ops/segment.py::rowwise_groupby_scan`), which retrieve_batch runs for a
CPU batch. Both functions take CUDA tensors only and raise on anything
else. Every word they write is the twin's, moved to its sorted lane.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from otto_tpu_torch.ops.kernels import _build
from otto_tpu_torch.utils import timing

# column launches since the last reset (see gather.LAUNCHES): one a batch
# retrieved on the card
LAUNCHES = timing.counter("otto::kernels.retrieval_columns")

# the level-1 reductions both launches read, in the kernel's order
# (retrieval_columns.cu `Input`): the keys of retrieve_batch's level-1
# groupby
INPUTS: Tuple[str, ...] = (
    *(f"cov{t}_{f}" for t in range(5)
      for f in ("count", "count_pop", "perc_pop", "count_rel", "rank")),
    "w2v_all_rank", "w2v_all_dist", "w2v_12_rank", "w2v_12_dist",
    "sa_src", "sa_n_aid", "sa_n_aid_clicks", "sa_n_aid_carts", "sa_n_aid_orders",
    "sa_rank_by_n_aid", "sa_rank_by_n_aid_carts", "sa_rank_by_n_aid_orders",
    "sa_max_ts_aid", "sa_max_ts_aid_clicks", "sa_max_ts_aid_carts", "sa_max_ts_aid_orders",
    "sa_ts_order_aid", "sa_ts_order_aid_rel", "sa_ts_order_aid_clicks",
    "sa_ts_order_aid_carts", "sa_ts_order_aid_orders", "sa_ts_aid_rel_pos_in_session",
    "sa_left_in_cart",
)
FLOAT_INPUTS = frozenset(("w2v_all_dist", "w2v_12_dist"))

# the columns written, by (dtype, reducer) group in the kernel's order
# (`Group`, and `Column` within each): what the level-2 groupby reduces
GROUPS: Tuple[Tuple[torch.dtype, str, Tuple[str, ...]], ...] = (
    (torch.int32, "sum", (
        "n_uniq_aid", "n_uniq_aid_clicks", "n_uniq_aid_carts", "n_uniq_aid_orders",
        "n_aid", "n_aid_clicks", "n_aid_carts", "n_aid_orders",
        "sum_rel_max_ts_aid", "sum_rel_max_ts_aid_orders", "cnt_max_ts_aid_orders",
        "sum_rel_pos",
        *(f"cov{t}_{f}" for t in range(5)
          for f in ("count", "num_count_pop", "num_perc_pop", "num_count_rel", "num_rank")),
        "w2v_all_n", "w2v_all_sum_rank", "w2v_12_n", "w2v_12_sum_rank",
        "slf_present", "slf_n", "slf_n_clicks", "slf_n_carts", "slf_n_orders",
        "slf_left_in_cart", "pop_present",
    )),
    (torch.int32, "max", (
        "max_ts_aid", "max_ts_aid_clicks", "max_ts_aid_carts", "max_ts_aid_orders",
        "slf_max_ts", "slf_max_ts_clicks", "slf_max_ts_carts", "slf_max_ts_orders",
    )),
    (torch.int32, "min", (
        "ts_order_aid", "ts_order_aid_rel", "ts_order_aid_clicks", "ts_order_aid_carts",
        "ts_order_aid_orders", "rank_by_n_aid", "w2v_all_best_rank", "w2v_12_best_rank",
        "slf_rank_by_n", "slf_rank_by_n_carts", "slf_rank_by_n_orders", "slf_ts_rel_pos",
        "slf_ts_order", "slf_ts_order_rel", "slf_ts_order_clicks", "slf_ts_order_carts",
        "slf_ts_order_orders", *(f"pop_{i}" for i in range(6)),
    )),
    (torch.float32, "sum", ("w2v_all_sum_dist", "w2v_12_sum_dist")),
)
COLUMNS: Tuple[str, ...] = tuple(n for _, _, names in GROUPS for n in names)
# name -> (dtype, reducer)
REDUCERS = {n: (dtype, red) for dtype, red, names in GROUPS for n in names}
# the popularity ranks a candidate carries (pop_0 ... pop_5)
N_POP = 6


def _need(name, t, dtype, shape=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"retrieval_columns: {name} is not a tensor")
    if t.dtype != dtype:
        raise TypeError(f"retrieval_columns: {name} is {t.dtype}, want {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"retrieval_columns: {name} {tuple(t.shape)} is not {tuple(shape)}")


def _check_inputs(inputs, S, P1, pop_ranks):
    """The level-1 inputs and the popularity ranks both launches read.
    -> (n_cl, T, K)."""
    if len(inputs) != len(INPUTS):
        raise ValueError(f"retrieval_columns: {len(inputs)} level-1 columns, the kernel's "
                         f"pointer block takes {len(INPUTS)} (INPUTS)")
    for n, t in zip(INPUTS, inputs):
        _need(f"input {n}", t, torch.float32 if n in FLOAT_INPUTS else torch.int32, (S, P1))
    _need("pop_ranks", pop_ranks, torch.int32)
    if pop_ranks.dim() != 3 or pop_ranks.shape[0] < 1 or pop_ranks.shape[2] < N_POP:
        raise ValueError(f"retrieval_columns: pop_ranks {tuple(pop_ranks.shape)} is not "
                         f"[n_cl >= 1, T, K >= {N_POP}]")
    return tuple(pop_ranks.shape)


def _check_layout(named):
    """Every tensor contiguous, all on one CUDA device."""
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"retrieval_columns: {name} is not contiguous")
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError("retrieval_columns: tensors on more than one device: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type != "cuda":
        raise ValueError(f"retrieval_columns: no kernel for {dev} (the plain twin is "
                         "engine/retrieval.py::_columns_program)")


def _ptrs(inputs):
    return (ctypes.c_void_p * len(inputs))(*[t.data_ptr() for t in inputs])


def retrieval_keys(ks1: torch.Tensor, end1: torch.Tensor, inputs: Sequence[torch.Tensor],
                   trim_params: torch.Tensor, cluster: torch.Tensor, pop_cand: torch.Tensor,
                   pop_ranks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The key launch, on the current stream: -> (key2 [S, P1 + T] int32,
    flags [S, P1] uint8). Every tensor contiguous, on one CUDA device."""
    inputs = list(inputs)
    _need("ks1", ks1, torch.int32)
    if ks1.dim() != 2:
        raise ValueError(f"retrieval_columns: ks1 {tuple(ks1.shape)} is not [S, P1]")
    S, P1 = ks1.shape
    _need("end1", end1, torch.bool, (S, P1))
    _need("trim_params", trim_params, torch.float32, (3,))
    _need("cluster", cluster, torch.int32, (S,))
    _need("pop_cand", pop_cand, torch.int32)
    n_cl, T, K = _check_inputs(inputs, S, P1, pop_ranks)
    if tuple(pop_cand.shape) != (n_cl, T):
        raise ValueError(f"retrieval_columns: pop_cand {tuple(pop_cand.shape)} and pop_ranks "
                         f"{tuple(pop_ranks.shape)} are not [n_cl, T] and [n_cl, T, K]")
    _check_layout([("ks1", ks1), ("end1", end1), ("trim_params", trim_params),
                   ("cluster", cluster), ("pop_cand", pop_cand), ("pop_ranks", pop_ranks),
                   *zip(INPUTS, inputs)])
    dev = ks1.device
    key2 = torch.empty((S, P1 + T), dtype=torch.int32, device=dev)
    flags = torch.empty((S, P1), dtype=torch.uint8, device=dev)
    if key2.numel() == 0:
        return key2, flags
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.otto_retrieval_keys(
            _ptrs(inputs), len(inputs), ks1.data_ptr(), end1.data_ptr(), trim_params.data_ptr(),
            cluster.data_ptr(), pop_cand.data_ptr(), pop_ranks.data_ptr(), n_cl, T, K,
            key2.data_ptr(), flags.data_ptr(), S, P1, stream)
    _build.check(err, "retrieval_keys")
    return key2, flags


def retrieval_columns(ks2: torch.Tensor, perm: torch.Tensor, flags: torch.Tensor,
                      inputs: Sequence[torch.Tensor], min_ts: torch.Tensor,
                      cluster: torch.Tensor, pop_ranks: torch.Tensor
                      ) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """The column launch, on the current stream, from the stable sort (ks2,
    perm) of retrieval_keys's key2 and its flags: -> ([one [G, S, P2] tensor
    a group of GROUPS], first [S, P2] bool, is_end [S, P2] bool). Every
    tensor contiguous, on one CUDA device."""
    inputs = list(inputs)
    _need("ks2", ks2, torch.int32)
    _need("flags", flags, torch.uint8)
    if ks2.dim() != 2 or flags.dim() != 2 or flags.shape[0] != ks2.shape[0]:
        raise ValueError(f"retrieval_columns: ks2 {tuple(ks2.shape)} and flags "
                         f"{tuple(flags.shape)} are not [S, P2] and [S, P1]")
    S, P2 = ks2.shape
    P1 = flags.shape[1]
    _need("perm", perm, torch.int64, (S, P2))
    _need("min_ts", min_ts, torch.int32, (S,))
    _need("cluster", cluster, torch.int32, (S,))
    n_cl, T, K = _check_inputs(inputs, S, P1, pop_ranks)
    if P2 != P1 + T:
        raise ValueError(f"retrieval_columns: {P2} sorted lanes, not the {P1} level-1 lanes "
                         f"and the {T} popularity slots")
    _check_layout([("ks2", ks2), ("perm", perm), ("flags", flags), ("min_ts", min_ts),
                   ("cluster", cluster), ("pop_ranks", pop_ranks), *zip(INPUTS, inputs)])
    dev = ks2.device
    out = torch.empty((len(COLUMNS), S, P2), dtype=torch.int32, device=dev)
    first = torch.empty((S, P2), dtype=torch.bool, device=dev)
    is_end = torch.empty((S, P2), dtype=torch.bool, device=dev)
    groups, at = [], 0
    for dtype, _, names in GROUPS:
        groups.append(out[at:at + len(names)].view(dtype))
        at += len(names)
    if first.numel() == 0:
        return groups, first, is_end
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.otto_retrieval_columns(
            _ptrs(inputs), len(inputs), ks2.data_ptr(), perm.data_ptr(), flags.data_ptr(),
            min_ts.data_ptr(), cluster.data_ptr(), pop_ranks.data_ptr(), n_cl, T, K,
            out.data_ptr(), first.data_ptr(), is_end.data_ptr(), S, P1, P2, stream)
    _build.check(err, "retrieval_columns")
    LAUNCHES.add()   # the pipelined runners launch from two threads
    return groups, first, is_end
