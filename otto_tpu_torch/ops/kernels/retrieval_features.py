"""K7: retrieval's Stage E after the transport sort, in one kernel.

`pk` [S, C] int32, the slots' sort keys after Stage E's transport sort
(SENTINEL where a slot is empty), and the C kept lanes of the columns it
moved, in COLUMNS order (cand, ts_order, then the Stage D groupby's
reductions, int32 but for the two float32 w2vec distance sums), the session
stats [S] int32 in STATS order, the popularity ranks pop_cl1_rank [A, K]
int32, the item embeddings aid_emb [A, D] and the session embeddings
ses_emb [S, D] float32 -> (cand [S, max_candidates] int32, feats [S,
max_candidates, 104] float32 in engine/retrieval.py FEATURE_NAMES order,
ts_order [S, max_candidates] int32), as retrieve_batch returns them.

The CUDA kernel is `otto_tpu_torch/csrc/retrieval_features.cu`; its plain
twin is `engine/retrieval.py::_features_program`, which retrieve_batch runs
for a CPU batch. `retrieval_features` takes CUDA tensors only and raises on
anything else. Every feature is bit-equal to the twin on the card but
cos_sim_ses_aid and eucl_dist_ses_aid, whose dot product and norms the
kernel sums in its own order.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from otto_tpu_torch.ops.kernels import _build
from otto_tpu_torch.utils import timing

# kernel launches since the last reset (see gather.LAUNCHES)
LAUNCHES = timing.counter("otto::kernels.retrieval_features")

# the columns a launch reads, in the kernel's order (retrieval_features.cu
# `Column`): the moved candidate and ts_order, then the Stage D reductions
COLUMNS: Tuple[str, ...] = (
    "cand", "ts_order",
    "n_uniq_aid", "n_uniq_aid_clicks", "n_uniq_aid_carts", "n_uniq_aid_orders",
    "n_aid", "n_aid_clicks", "n_aid_carts", "n_aid_orders",
    "max_ts_aid", "max_ts_aid_clicks", "max_ts_aid_carts", "max_ts_aid_orders",
    "sum_rel_max_ts_aid", "sum_rel_max_ts_aid_orders", "cnt_max_ts_aid_orders",
    "ts_order_aid_rel", "ts_order_aid_clicks", "ts_order_aid_carts", "ts_order_aid_orders",
    "rank_by_n_aid", "sum_rel_pos",
    *(f"cov{t}_{f}" for t in range(5)
      for f in ("count", "num_count_pop", "num_perc_pop", "num_count_rel", "num_rank")),
    *(f"{m}_{f}" for m in ("w2v_all", "w2v_12")
      for f in ("n", "sum_rank", "best_rank", "sum_dist")),
    "slf_present", "slf_n", "slf_n_clicks", "slf_n_carts", "slf_n_orders",
    "slf_rank_by_n", "slf_rank_by_n_carts", "slf_rank_by_n_orders",
    "slf_max_ts", "slf_max_ts_clicks", "slf_max_ts_carts", "slf_max_ts_orders",
    "slf_ts_rel_pos", "slf_ts_order", "slf_ts_order_rel", "slf_ts_order_clicks",
    "slf_ts_order_carts", "slf_ts_order_orders", "slf_left_in_cart",
    *(f"pop_{i}" for i in range(6)), "pop_present",
)
FLOAT_COLUMNS = frozenset(("w2v_all_sum_dist", "w2v_12_sum_dist"))
# the session stats, in the kernel's order (`Stat`; SessionStats fields)
STATS: Tuple[str, ...] = ("n_events", "n_aids", "n_clicks", "n_carts", "n_orders",
                          "duration", "only_orders", "max_ts", "min_ts")
N_FEATURES = 104
# the widest embedding a block stages in shared memory (MAX_D)
MAX_D = 1024


def _check(pk, cols, stats, pop_cl1_rank, aid_emb, ses_emb, max_candidates):
    if len(cols) != len(COLUMNS):
        raise ValueError(f"retrieval_features: {len(cols)} columns, the kernel's pointer "
                         f"block takes {len(COLUMNS)} (COLUMNS)")
    if len(stats) != len(STATS):
        raise ValueError(f"retrieval_features: {len(stats)} session stats, the kernel "
                         f"takes {len(STATS)} (STATS)")
    want = [("pk", pk, torch.int32), ("pop_cl1_rank", pop_cl1_rank, torch.int32),
            ("aid_emb", aid_emb, torch.float32), ("ses_emb", ses_emb, torch.float32)]
    want += [(f"column {n}", t, torch.float32 if n in FLOAT_COLUMNS else torch.int32)
             for n, t in zip(COLUMNS, cols)]
    want += [(f"stat {n}", t, torch.int32) for n, t in zip(STATS, stats)]
    for name, t, dtype in want:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"retrieval_features: {name} is not a tensor")
        if t.dtype != dtype:
            raise TypeError(f"retrieval_features: {name} is {t.dtype}, want {dtype}")
    if pk.dim() != 2:
        raise ValueError(f"retrieval_features: pk {tuple(pk.shape)} is not [S, C]")
    S, C = pk.shape
    bad = [n for n, t in zip(COLUMNS, cols) if t.shape != (S, C)]
    bad += [n for n, t in zip(STATS, stats) if t.shape != (S,)]
    if bad:
        raise ValueError(f"retrieval_features: {bad[:4]} are not [S, C] = {(S, C)} "
                         "columns or [S] stats")
    if (pop_cl1_rank.dim() != 2 or pop_cl1_rank.shape[0] < 1 or pop_cl1_rank.shape[1] < 3
            or aid_emb.dim() != 2 or aid_emb.shape[0] < 1 or ses_emb.dim() != 2
            or ses_emb.shape != (S, aid_emb.shape[1])
            or not 1 <= aid_emb.shape[1] <= MAX_D):
        raise ValueError(
            f"retrieval_features: pop_cl1_rank {tuple(pop_cl1_rank.shape)}, aid_emb "
            f"{tuple(aid_emb.shape)}, ses_emb {tuple(ses_emb.shape)} are not [A, K >= 3], "
            f"[A, D] and [S, D] with 1 <= D <= {MAX_D}")
    if max_candidates < C:
        raise ValueError(f"retrieval_features: max_candidates {max_candidates} below the "
                         f"{C} lanes kept")
    if C > 1 and pk.stride(1) != 1:
        raise ValueError("retrieval_features: pk's lanes are not contiguous")
    for name, t in [("pop_cl1_rank", pop_cl1_rank), ("aid_emb", aid_emb), ("ses_emb", ses_emb),
                    *zip(COLUMNS, cols), *zip(STATS, stats)]:
        if not t.is_contiguous():
            raise ValueError(f"retrieval_features: {name} is not contiguous")
    devices = {t.device for t in (pk, pop_cl1_rank, aid_emb, ses_emb, *cols, *stats)}
    if len(devices) != 1:
        raise ValueError("retrieval_features: tensors on more than one device: "
                         f"{sorted(map(str, devices))}")
    if pk.device.type != "cuda":
        raise ValueError(f"retrieval_features: no kernel for {pk.device} (the plain twin "
                         "is engine/retrieval.py::_features_program)")


def retrieval_features(pk: torch.Tensor, cols: Sequence[torch.Tensor],
                       stats: Sequence[torch.Tensor], pop_cl1_rank: torch.Tensor,
                       aid_emb: torch.Tensor, ses_emb: torch.Tensor, max_candidates: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch on the current stream: (cand, feats, ts_order) with
    max_candidates slots a session, the slots from C on padding (cand -1,
    ts_order 999, features 0). pk may be a view with a row stride of at
    least C (its lanes contiguous); every other tensor contiguous, all on
    one CUDA device."""
    cols, stats = list(cols), list(stats)
    _check(pk, cols, stats, pop_cl1_rank, aid_emb, ses_emb, max_candidates)
    S, C = pk.shape
    dev = pk.device
    cand = torch.empty((S, max_candidates), dtype=torch.int32, device=dev)
    ts_order = torch.empty((S, max_candidates), dtype=torch.int32, device=dev)
    feats = torch.empty((S, max_candidates, N_FEATURES), dtype=torch.float32, device=dev)
    if cand.numel() == 0:
        return cand, feats, ts_order
    lib = _build.load()
    col_ptrs = (ctypes.c_void_p * len(cols))(*[t.data_ptr() for t in cols])
    stat_ptrs = (ctypes.c_void_p * len(stats))(*[t.data_ptr() for t in stats])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.otto_retrieval_features(
            col_ptrs, len(cols), stat_ptrs, len(stats), pk.data_ptr(), max(pk.stride(0), C),
            pop_cl1_rank.data_ptr(), pop_cl1_rank.shape[0], pop_cl1_rank.shape[1],
            aid_emb.data_ptr(), aid_emb.shape[0], ses_emb.data_ptr(), aid_emb.shape[1],
            cand.data_ptr(), ts_order.data_ptr(), feats.data_ptr(), S, C, max_candidates,
            stream)
    _build.check(err, "retrieval_features")
    LAUNCHES.add()   # the pipelined runners launch from two threads
    return cand, feats, ts_order
