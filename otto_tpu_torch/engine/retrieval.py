"""Multi-source candidate retrieval + feature generation.

Counterpart of otto_tpu/engine/retrieval.py. Candidates live on a dense
per-session grid:

  Stage A  per-session / per-session-aid stats          [S, A_k]
  Stage B  source fan-out: every kept session aid gathers its top-N lists
           from the dense co-visit / w2vec tables; the session-cluster
           popularity list is appended                   [S, P] entries
  Stage C  level-1 dedup by (session-aid, candidate), which joins the per-
           pair features across sources, then the recency-adaptive trim
  Stage D  level-2 groupby candidate (the aggregation catalogue)
  Stage E  compaction to C_max candidates + derived / session / popularity
           / similarity features + null-fill conventions

Output: candidate ids [S, C] + a [S, C, F] feature tensor in the canonical
FEATURE_NAMES order (the ranker's input contract).

Known deviation, kept from otto_tpu: the original slf_* min/max aggregates
multiply by (aid == aid_next) before reducing over the group, which zeroes
them whenever any non-self pair exists in the group; here, as in otto_tpu,
the true self value propagates (0/NULL when the candidate is not a session
aid).

Stages C, D and E are sorted-layout groupbys (ops/segment.py): their
column moves run on kernel K1 and their scans on kernel K2. On the card,
Stage D's trim and columns are kernel K8's two launches around the key
sort (ops/kernels/retrieval_columns.py), which writes the columns in sort
order, and Stage E's features, after its transport sort, one launch of
kernel K7 (ops/kernels/retrieval_features.py); elsewhere their twins
_columns_program and _features_program run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from otto_tpu_torch.config import RetrievalConfig
from otto_tpu_torch.data.batching import iter_microbatches, pack_sessions
from otto_tpu_torch.data.schema import Events
from otto_tpu_torch.engine.covis import CoVisTables
from otto_tpu_torch.engine.session_stats import (
    compute_session_aids,
    compute_session_stats,
)
from otto_tpu_torch.ops import segment as seg
from otto_tpu_torch.ops.kernels import retrieval_columns as k8
from otto_tpu_torch.ops.kernels import retrieval_features as k7
from otto_tpu_torch.utils import timing

SENT = seg.SENTINEL
NEG_SENT = seg.NEG_SENTINEL
NULL = -1
AID_BITS = 21  # aids < 2^21 (1.8M items)
AID_MASK = (1 << AID_BITS) - 1
I32 = torch.int32
F32 = torch.float32
BIG_F = 3.4e38  # float "absent" distance; rounds to the same f32 as otto_tpu's

COVIS_NAMES = (
    "click_to_click",
    "click_to_cart_or_buy",
    "cart_to_cart",
    "cart_to_buy",
    "buy_to_buy",
)
POP_RANK_NAMES = (
    "rank_clicks", "rank_carts", "rank_orders",
    "rank_clicks_7d", "rank_carts_7d", "rank_orders_7d",
)

# canonical feature order (the ranker input contract)
FEATURE_NAMES: Tuple[str, ...] = (
    # session-level
    "n_events_session", "n_aids_session", "n_clicks_session",
    "n_carts_session", "n_orders_session", "duration_session",
    "only_orders_session",
    # self features
    "slf_n", "slf_n_clicks", "slf_n_carts", "slf_n_orders",
    "slf_rank_by_n", "slf_rank_by_n_carts", "slf_rank_by_n_orders",
    "slf_since_ts", "slf_since_ts_clicks", "slf_since_ts_carts",
    "slf_since_ts_orders", "slf_ts_rel_pos_in_session", "slf_ts_order",
    "slf_ts_order_rel", "slf_ts_order_clicks", "slf_ts_order_carts",
    "slf_ts_order_orders", "slf_left_in_cart",
    # aggregated session-aid features
    "n_uniq_aid", "n_uniq_aid_clicks", "n_uniq_aid_carts", "n_uniq_aid_orders",
    "n_aid", "n_aid_clicks", "n_aid_carts", "n_aid_orders",
    "since_ts_aid", "since_ts_aid_clicks", "since_ts_aid_carts",
    "since_ts_aid_orders", "since_session_start_ts_aid",
    "since_session_start_ts_aid_orders", "rel_pos_max_ts_aid_in_session",
    "rel_pos_mean_max_ts_aid_in_session",
    "rel_pos_mean_max_ts_aid_orders_in_session",
    "ts_order_aid", "ts_order_aid_rel", "ts_order_aid_clicks",
    "ts_order_aid_carts", "ts_order_aid_orders", "ts_aid_rel_pos_in_session",
    "rank_by_n_aid",
    # co-visitation features x5
    *(f"{n}_{f}" for n in COVIS_NAMES
      for f in ("count", "count_pop", "perc_pop", "rank", "count_rel")),
    # w2vec features
    "n_w2vec_all", "dist_w2vec_all", "rank_w2vec_all", "best_rank_w2vec_all",
    "n_w2vec_1_2", "dist_w2vec_1_2", "rank_w2vec_1_2", "best_rank_w2vec_1_2",
    # source flags
    "src_any", "src_self", "src_click_to_click", "src_click_to_cart_or_buy",
    "src_cart_to_cart", "src_cart_to_buy", "src_buy_to_buy", "src_w2vec_all",
    "src_w2vec_1_2", "src_pop_cl50",
    # cluster popularity ranks
    *(f"{n}_cl50" for n in POP_RANK_NAMES),
    "rank_clicks_cl1", "rank_carts_cl1", "rank_orders_cl1",
    # embedding similarity
    "cos_sim_ses_aid", "eucl_dist_ses_aid",
    # cross-source heuristic prior: recency-weighted normalized co-visit
    # mass (the baseline recommender's score as a ranker input)
    "heur_score",
)
FEATURE_INDEX = {n: i for i, n in enumerate(FEATURE_NAMES)}

# candidate-source flag columns, in bit order for the packed meta
# (eval.per_source.SOURCES is this tuple)
SOURCE_FLAGS: Tuple[str, ...] = (
    "src_any", "src_self", "src_click_to_click", "src_click_to_cart_or_buy",
    "src_cart_to_cart", "src_cart_to_buy", "src_buy_to_buy", "src_w2vec_all",
    "src_w2vec_1_2", "src_pop_cl50",
)
F16_MAX = 65504.0


# ---------------------------------------------------------------------------
# pass A: packed meta, the label join and the downsample keep bits
# ---------------------------------------------------------------------------
def _pack_meta_program(cand: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """[S, C] int32 of ((cand + 1) << n_src) | source-flag bits (bit k =
    SOURCE_FLAGS[k] > 0): pass A's per-batch host needs in one pull (aids
    below 2^21 leave room for the 10 flags in 31 bits)."""
    idx = torch.tensor([FEATURE_INDEX[s] for s in SOURCE_FLAGS], device=feats.device)
    bits = (feats[:, :, idx] > 0).to(I32)
    w = (1 << torch.arange(len(SOURCE_FLAGS), dtype=I32, device=feats.device))
    flags = (bits * w).sum(dim=-1, dtype=I32)
    return ((cand + 1) << len(SOURCE_FLAGS)) | flags


def _label_bits_program(cand, session, lab0, lab1, lab2) -> torch.Tensor:
    """The label join on the device: bit t of the [S, C] uint8 result says
    the candidate is a type-t label of its session. lab0..2 are sorted
    int64 keys (session << AID_BITS) | aid (label_keys_device); the keys
    take 45 bits, so they are int64 throughout."""
    key = (session.to(torch.int64)[:, None] << AID_BITS) | cand.clamp(min=0).to(torch.int64)
    bits = torch.zeros(cand.shape, dtype=torch.uint8, device=cand.device)
    for t, lab in enumerate((lab0, lab1, lab2)):
        n = lab.shape[0]
        pos = torch.searchsorted(lab, key)
        hit = (pos < n) & (lab[pos.clamp(max=n - 1)] == key) & (cand >= 0)
        bits |= hit.to(torch.uint8) << t
    return bits


def _label_keep_bits_program(cand, session, lab0, lab1, lab2, generator,
                             neg_ratio: int, neg_cap: int) -> torch.Tensor:
    """_label_bits_program (bits 0-2) plus the downsample keep bits (bits
    3-5): per type, every positive and min(neg_ratio * n_pos, neg_cap)
    negatives of each session with a positive, the negatives of smallest
    uniform priority (drawn from `generator`, one [S, C] draw per type)."""
    bits = _label_bits_program(cand, session, lab0, lab1, lab2)
    valid = cand >= 0
    S, C = cand.shape
    out = bits.clone()
    for t in range(3):
        y = ((bits >> t) & 1) > 0
        pos = y & valid
        n_pos = pos.sum(dim=1)
        max_neg = (n_pos * neg_ratio).clamp(max=neg_cap)
        prio = torch.rand((S, C), generator=generator, device=cand.device)
        neg = valid & ~y
        masked = torch.where(neg, prio, 2.0)   # non-negatives sort past 1.0
        srt = torch.sort(masked, dim=1).values
        # the max_neg-th smallest negative priority; with fewer negatives
        # than max_neg it lands on a 2.0 slot and every negative keeps
        thr = srt.gather(1, (max_neg - 1).clamp(0, C - 1)[:, None])
        keep_neg = neg & (masked <= thr) & (max_neg > 0)[:, None]
        keep = (pos | keep_neg) & (n_pos > 0)[:, None]
        out |= keep.to(torch.uint8) << (3 + t)
    return out


def label_keys_device(labels, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sorted per-type (session << AID_BITS | aid) int64 key tables on
    `device` for _label_bits_program; a type without labels gets the one
    key -1, which matches nothing."""
    out = []
    for tid in (0, 1, 2):
        lab = labels.for_type(tid)
        key = np.sort((lab.session.astype(np.int64) << AID_BITS) | lab.aid.astype(np.int64))
        if len(key) == 0:
            key = np.array([-1], np.int64)
        out.append(torch.from_numpy(key).to(device))
    return tuple(out)


class RetrievalContext(NamedTuple):
    """Device-resident tables feeding retrieval (all on one device)."""

    covis: Tuple[CoVisTables, ...]              # aligned with COVIS_NAMES
    knn_all: Tuple[torch.Tensor, torch.Tensor]  # neighbor [A, k], dist [A, k]
    knn_1_2: Tuple[torch.Tensor, torch.Tensor]
    pop_cl50_cand: torch.Tensor                 # [C50, T] aid, -1 pad
    pop_cl50_ranks: torch.Tensor                # [C50, T, 6]
    pop_cl1_rank: torch.Tensor                  # [A, 6]
    aid_emb: torch.Tensor                       # [A, D]

    def tensors(self) -> List[torch.Tensor]:
        """Every table, flattened in field order."""
        out = []

        def walk(x):
            if isinstance(x, torch.Tensor):
                out.append(x)
            else:
                for y in x:
                    walk(y)

        walk(self)
        return out

    def to(self, device) -> "RetrievalContext":
        """The same tables on `device`."""

        def move(x):
            if isinstance(x, torch.Tensor):
                return x.to(device)
            items = [move(y) for y in x]
            return type(x)(*items) if hasattr(x, "_fields") else tuple(items)

        return move(self)


class RetrievedBatch:
    """One retrieval batch. `feats` [n_keep, C, F] stays on the device and
    arrives keep-filtered to the real sessions; `cand` / `ts_order` are
    kept as full [S, C] device tensors and filtered with `keep` (row
    indices of the real sessions, None = all) on access, as is `history`,
    the padded (aid, ts, type) [S, L] the batch was retrieved from (None
    for a batch made elsewhere; the HSTU ranker reads it). `index`: the
    batch's place in one device's batch order (Retriever.iter_run's; None
    for a batch made elsewhere)."""

    def __init__(self, session, cand, feats, ts_order, keep=None, index=None, history=None):
        self.session = session
        self.index = index
        self.feats = feats
        self._cand = cand
        self._ts_order = ts_order
        self._history = tuple(history) if history is not None else None
        self._keep = keep
        self._host = {}

    def _filtered(self, x: torch.Tensor) -> torch.Tensor:
        if self._keep is None:
            return x
        return x[torch.as_tensor(self._keep, device=x.device)]

    def device_tensors(self) -> List[torch.Tensor]:
        """The batch's tensors on its device (features, candidates,
        ts_order, the history's three)."""
        return [self.feats, self._cand, self._ts_order, *(self._history or ())]

    def cand_device(self) -> torch.Tensor:
        """[n_keep, C] int32 candidates on the device."""
        return self._filtered(self._cand)

    def history_device(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(aid, ts, type) [n_keep, L] int32 on the device: each session's
        events left-aligned, aid -1 past its end."""
        if self._history is None:
            raise ValueError("this RetrievedBatch carries no history")
        return tuple(self._filtered(x) for x in self._history)

    def _pull(self, name: str, x: torch.Tensor) -> np.ndarray:
        if name not in self._host:
            self._host[name] = self._filtered(x).cpu().numpy()
        return self._host[name]

    @property
    def cand(self) -> np.ndarray:
        return self._pull("cand", self._cand)

    @property
    def ts_order(self) -> np.ndarray:
        return self._pull("ts_order", self._ts_order)

    def _session_device(self) -> torch.Tensor:
        return torch.from_numpy(np.asarray(self.session)).to(self.feats.device)

    def pack_meta(self) -> torch.Tensor:
        """[n_keep, C] int32 packed (cand, source flags) on the device
        (_pack_meta_program); unpack_meta pulls it."""
        return _pack_meta_program(self.cand_device(), self.feats)

    def pack_meta_labels(self, label_keys):
        """(pack_meta(), [n_keep, C] uint8 label bits) on the device;
        label_keys from label_keys_device."""
        cand = self.cand_device()
        return (_pack_meta_program(cand, self.feats),
                _label_bits_program(cand, self._session_device(), *label_keys))

    def pack_meta_labels_select(self, label_keys, generator, neg_ratio, neg_cap):
        """pack_meta_labels with the downsample keep bits in bits 3-5 of
        the label bits (RankerConfig.device_select)."""
        cand = self.cand_device()
        return (_pack_meta_program(cand, self.feats),
                _label_keep_bits_program(cand, self._session_device(), *label_keys,
                                         generator, int(neg_ratio), int(neg_cap)))

    def unpack_meta(self, meta) -> np.ndarray:
        """Pull a pack_meta() result (the tensor, or its HostCopy): caches
        the keep-filtered candidates as this batch's `cand` and returns the
        [n_keep, C] uint16 source-flag bits (bit k = SOURCE_FLAGS[k])."""
        m = meta.numpy() if isinstance(meta, HostCopy) else meta.cpu().numpy()
        self._host["cand"] = ((m >> len(SOURCE_FLAGS)) - 1).astype(np.int32)
        return (m & ((1 << len(SOURCE_FLAGS)) - 1)).astype(np.uint16)

    def _rows_f16(self, si: np.ndarray, ci: np.ndarray) -> torch.Tensor:
        dev = self.feats.device
        rows = self.feats[torch.from_numpy(np.asarray(si, np.int64)).to(dev),
                          torch.from_numpy(np.asarray(ci, np.int64)).to(dev)]
        return rows.clamp(-F16_MAX, F16_MAX).to(torch.float16)

    def feats_rows(self, si: np.ndarray, ci: np.ndarray) -> np.ndarray:
        """The [n, F] candidate rows (si, ci), gathered on the device,
        clipped to +-65504 and rounded to float16 there; returned as
        float32."""
        return self._rows_f16(si, ci).cpu().numpy().astype(np.float32)

    def feats_rows_async(self, si: np.ndarray, ci: np.ndarray):
        """(handle, n): the [n, F] float16 rows of feats_rows, gathered on
        the current stream and copied to the host asynchronously (a
        HostCopy; np.asarray(handle) waits for it)."""
        return HostCopy(self._rows_f16(si, ci)), len(si)


class HostCopy:
    """A device -> host copy in flight. For a CUDA tensor: a non_blocking
    copy into pinned host memory, issued on the current stream, and an
    event recorded after it; `numpy()` (and np.asarray) waits for that
    event only, not for the rest of the device's queue. A CPU tensor is
    its own host copy."""

    def __init__(self, x: torch.Tensor):
        self.event = None
        if x.device.type == "cuda":
            self._host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self._host.copy_(x, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(x.device))
        else:
            self._host = x

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self._host.numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)


def _null_to(x, ident, repl):
    return torch.where(x == ident, repl, x)


def retrieve_batch(
    padded: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # aid, ts, type [S, L]
    ctx: RetrievalContext,
    cluster: torch.Tensor,        # [S] int32 session cl50 id
    ses_emb: torch.Tensor,        # [S, D] session embeddings
    trim_params: torch.Tensor,    # [3] float32: max_at_1, min_n, delta
    keep_aids: int,
    max_candidates: int,
):
    """-> (cand [S, max_candidates] int32 (-1 pad), feats [S,
    max_candidates, F] float32, ts_order [S, max_candidates] int32)."""
    stage = timing.span("otto::retrieval.stage_a").open()
    aid, ts, type_ = padded
    S, L = aid.shape
    dev = aid.device

    def full(shape, value, dtype=I32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    sa = compute_session_aids(aid, ts, type_, min(keep_aids, L))
    A_k = sa.aid.shape[1]  # may be < keep_aids for short buckets
    ss = compute_session_stats(aid, ts, type_)

    src_aid = sa.aid                                     # [S, A_k]
    src_ok = src_aid >= 0
    ga = src_aid.clamp(min=0).long()

    stage = stage.then("otto::retrieval.stage_b")
    # ---------------- Stage B: source fan-out --------------------------------
    cand_blocks: List[torch.Tensor] = [torch.where(src_ok, src_aid, -1)[:, :, None]]
    for nbr_t in [t.neighbor for t in ctx.covis] + [ctx.knn_all[0], ctx.knn_1_2[0]]:
        nbr = nbr_t[ga]                                  # [S, A_k, N]
        ok = src_ok[:, :, None] & (nbr >= 0)
        cand_blocks.append(torch.where(ok, nbr, -1))
    block_sizes = [b.shape[2] for b in cand_blocks]
    n_blocks = len(block_sizes)
    n_cov = len(ctx.covis)

    P1 = A_k * sum(block_sizes)
    cand_grid = torch.cat(cand_blocks, dim=2)            # [S, A_k, F_src]
    F_src = cand_grid.shape[2]
    src_i_grid = torch.arange(A_k, dtype=I32, device=dev)[None, :, None].expand(
        S, A_k, F_src
    )

    def blockify(bi: int, piece: torch.Tensor, ident) -> torch.Tensor:
        """[S, A_k, F_src]: `piece` in block bi, the identity elsewhere."""
        dtype = F32 if isinstance(ident, float) else I32
        return torch.cat(
            [
                piece.to(dtype) if i == bi else full((S, A_k, size), ident, dtype)
                for i, size in enumerate(block_sizes)
            ],
            dim=2,
        )

    def rank_cols(N: int) -> torch.Tensor:
        return torch.arange(1, N + 1, dtype=I32, device=dev)[None, None, :].expand(
            S, A_k, N
        )

    grids: Dict[str, torch.Tensor] = {}
    for t, tabs in enumerate(ctx.covis):
        bi = 1 + t
        ok = cand_blocks[bi] >= 0
        for fname, table in (
            ("count", tabs.count), ("count_pop", tabs.count_pop),
            ("perc_pop", tabs.perc_pop), ("count_rel", tabs.count_rel),
        ):
            grids[f"cov{t}_{fname}"] = blockify(bi, torch.where(ok, table[ga], 0), 0)
        grids[f"cov{t}_rank"] = blockify(
            bi, torch.where(ok, rank_cols(block_sizes[bi]), SENT), SENT
        )
    for kind, bi, (_, dist_t) in (
        ("w2v_all", n_blocks - 2, ctx.knn_all),
        ("w2v_12", n_blocks - 1, ctx.knn_1_2),
    ):
        ok = cand_blocks[bi] >= 0
        grids[f"{kind}_rank"] = blockify(
            bi, torch.where(ok, rank_cols(block_sizes[bi]), SENT), SENT
        )
        grids[f"{kind}_dist"] = blockify(
            bi, torch.where(ok, dist_t[ga].to(F32), BIG_F), BIG_F
        )

    # flatten grid entries
    flat_cand = cand_grid.reshape(S, P1)
    flat_i = src_i_grid.reshape(S, P1)
    key1 = torch.where(flat_cand >= 0, (flat_i << AID_BITS) | flat_cand, SENT)

    stage = stage.then("otto::retrieval.stage_c")
    # ---------------- Stage C: level-1 dedup + trim --------------------------
    # per-source-aid stats ride the level-1 sort as segment-constant 'carry'
    # payloads (every entry of a (source-aid, cand) segment shares its
    # source aid)
    def carry_of(arr):  # [S, A_k] -> [S, P1] broadcast along the block dim
        return arr[:, :, None].expand(S, A_k, F_src).reshape(S, P1)

    SA_CARRY = (
        ("src", src_aid),
        ("n_aid", sa.n_aid),
        ("n_aid_clicks", sa.n_aid_clicks),
        ("n_aid_carts", sa.n_aid_carts),
        ("n_aid_orders", sa.n_aid_orders),
        ("rank_by_n_aid", sa.rank_by_n_aid),
        ("rank_by_n_aid_carts", sa.rank_by_n_aid_carts),
        ("rank_by_n_aid_orders", sa.rank_by_n_aid_orders),
        ("max_ts_aid", sa.max_ts_aid),
        ("max_ts_aid_clicks", sa.max_ts_aid_clicks),
        ("max_ts_aid_carts", sa.max_ts_aid_carts),
        ("max_ts_aid_orders", sa.max_ts_aid_orders),
        ("ts_order_aid", sa.ts_order_aid),
        ("ts_order_aid_rel", sa.ts_order_aid_rel),
        ("ts_order_aid_clicks", sa.ts_order_aid_clicks),
        ("ts_order_aid_carts", sa.ts_order_aid_carts),
        ("ts_order_aid_orders", sa.ts_order_aid_orders),
        ("ts_aid_rel_pos_in_session", sa.ts_aid_rel_pos_in_session),
        ("left_in_cart", sa.left_in_cart),
    )

    cols1 = {}
    for t in range(n_cov):
        for f in ("count", "count_pop", "perc_pop", "count_rel"):
            cols1[f"cov{t}_{f}"] = (grids[f"cov{t}_{f}"].reshape(S, P1), "max")
        cols1[f"cov{t}_rank"] = (grids[f"cov{t}_rank"].reshape(S, P1), "min")
    for kind in ("w2v_all", "w2v_12"):
        cols1[f"{kind}_rank"] = (grids[f"{kind}_rank"].reshape(S, P1), "min")
        cols1[f"{kind}_dist"] = (grids[f"{kind}_dist"].reshape(S, P1), "min")
    for name, arr in SA_CARRY:
        cols1[f"sa_{name}"] = (carry_of(arr), "carry")
    del grids

    ks1, red1, end1, _ = seg.rowwise_groupby_scan(key1, cols1)
    del cols1

    stage = stage.then("otto::retrieval.stage_d")
    # ---------------- Stage D: trim + level-2 groupby candidate --------------
    ks2, red2, end2 = _stage_d(ks1, red1, end1, ss.min_ts, cluster, ctx, trim_params)
    del red1

    stage = stage.then("otto::retrieval.stage_e")
    # ---------------- Stage E: compaction ------------------------------------
    # one transport sort keyed on the per-candidate ts_order priority
    # (segment ends only) compacts the groupby result and applies the
    # top-C cut together: only the C kept lanes move, and only the columns
    # the features read
    ts_order = torch.where(end2, _null_to(red2["ts_order_aid"], SENT, 999), SENT)
    prio = torch.where(end2, ts_order.clamp(0, 999), SENT)
    # a cap beyond the union's lane width is a no-op (there can be no more
    # candidates than lanes)
    C = min(max_candidates, prio.shape[1])
    pk, comp = seg.rowwise_transport_sort(
        prio,
        [torch.where(end2, ks2, -1), ts_order] + [red2[n] for n in k7.COLUMNS[2:]],
        width=C,
    )
    del red2
    idents = {n: seg._reduce_identity(*k8.REDUCERS[n]) for n in k7.COLUMNS[2:]}
    cand, feats, ts_out = _stage_e(pk, dict(zip(k7.COLUMNS, comp)), idents, ss, ctx,
                                   ses_emb, max_candidates)
    stage.close()
    return cand, feats, ts_out


def _stage_d(ks1, red1, end1, min_ts, cluster, ctx, trim_params):
    """The trim and the level-2 groupby by candidate: for a batch on the
    card, K8's key launch, the key sort, K8's column launch and one K2 scan
    a column group as it lies; elsewhere the twin _columns_program and
    rowwise_groupby_scan. -> (ks2 [S, P2] sorted keys, {name: scanned
    [S, P2]} for every name of k8.COLUMNS, is_end [S, P2])."""
    if ks1.device.type != "cuda":
        ks2, red2, end2, _ = seg.rowwise_groupby_scan(
            *_columns_program(ks1, red1, end1, min_ts, cluster, ctx, trim_params))
        return ks2, red2, end2
    inputs = [red1[n] for n in k8.INPUTS]
    key2, flags = k8.retrieval_keys(ks1, end1, inputs, trim_params, cluster,
                                    ctx.pop_cl50_cand, ctx.pop_cl50_ranks)
    ks2, perm = torch.sort(key2, dim=-1, stable=True)
    groups, first, end2 = k8.retrieval_columns(ks2, perm, flags, inputs, min_ts, cluster,
                                              ctx.pop_cl50_ranks)
    red2: Dict[str, torch.Tensor] = {}
    for (_, red, names), cols in zip(k8.GROUPS, groups):
        red2.update(zip(names, seg.segmented_scan(cols, first, red)))
    return ks2, red2, end2


def _columns_program(ks1, red1, end1, min_ts, cluster, ctx, trim_params):
    """K8's plain twin (ops/kernels/retrieval_columns.py): from the level-1
    groupby's sorted keys ks1, reductions red1 {name: [S, P1]} and segment
    ends end1, the recency-adaptive trim and the level-2 groupby's input:
    -> (key2 [S, P1 + T] int32, {name: (column [S, P1 + T], reducer)}) for
    the names of k8.COLUMNS, the popularity candidates in the last T
    lanes."""
    S, P1 = ks1.shape
    dev = ks1.device
    n_cov = len(ctx.covis)

    def full(shape, value, dtype=I32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    # sorted layout: reduced values live at segment-END lanes only
    e_valid = end1
    e_cand = torch.where(ks1 != SENT, ks1 & AID_MASK, -1)

    def stat_of(name):  # carried per-source-aid stat, aligned to entries
        return red1[f"sa_{name}"]

    is_self = e_valid & (e_cand == stat_of("src"))

    # recency-adaptive trim
    orders = [
        _null_to(stat_of(n), NULL, SENT)
        for n in ("rank_by_n_aid", "ts_order_aid", "ts_order_aid_clicks",
                  "ts_order_aid_carts", "ts_order_aid_orders")
    ]
    best_order = torch.minimum(
        torch.minimum(torch.minimum(orders[0], orders[1]), orders[2]),
        torch.minimum(orders[3], orders[4]),
    ).to(F32)
    max_at_1, min_n, delta = trim_params[0], trim_params[1], trim_params[2]
    th = torch.maximum(max_at_1 - delta * (best_order - 1.0), min_n)

    best_co = red1["cov0_rank"]
    for t in range(1, n_cov):
        best_co = torch.minimum(best_co, red1[f"cov{t}_rank"])
    best_w2v = torch.minimum(red1["w2v_all_rank"], red1["w2v_12_rank"])

    keep = e_valid & (
        is_self | (best_co.to(F32) <= th) | (best_w2v.to(F32) <= th)
    )

    # ---------------- level-2 groupby candidate ------------------------------
    key2_main = torch.where(keep, e_cand, SENT)

    def masked(arr, ident):
        return torch.where(keep, arr, ident)

    cols2: Dict[str, Tuple[torch.Tensor, str]] = {}
    cols2["n_uniq_aid"] = (keep.to(I32), "sum")
    for suff in ("clicks", "carts", "orders"):
        cols2[f"n_uniq_aid_{suff}"] = (
            (keep & (stat_of(f"n_aid_{suff}") > 0)).to(I32), "sum")
    for name in ("n_aid", "n_aid_clicks", "n_aid_carts", "n_aid_orders"):
        cols2[name] = (masked(stat_of(name), 0), "sum")

    mt = stat_of("max_ts_aid")
    min_ts_col = min_ts[:, None]  # session-start-relative sums stay in i32
    cols2["max_ts_aid"] = (masked(_null_to(mt, NULL, NEG_SENT), NEG_SENT), "max")
    cols2["sum_rel_max_ts_aid"] = (
        masked(torch.where(mt == NULL, 0, mt - min_ts_col), 0), "sum")
    for suff in ("clicks", "carts", "orders"):
        a = stat_of(f"max_ts_aid_{suff}")
        cols2[f"max_ts_aid_{suff}"] = (
            masked(_null_to(a, NULL, NEG_SENT), NEG_SENT), "max")
    mto = stat_of("max_ts_aid_orders")
    has_o = keep & (mto != NULL)
    cols2["sum_rel_max_ts_aid_orders"] = (
        torch.where(has_o, mto - min_ts_col, 0), "sum")
    cols2["cnt_max_ts_aid_orders"] = (has_o.to(I32), "sum")

    for name in (
        "ts_order_aid", "ts_order_aid_rel", "ts_order_aid_clicks",
        "ts_order_aid_carts", "ts_order_aid_orders", "rank_by_n_aid",
    ):
        cols2[name] = (masked(_null_to(stat_of(name), NULL, SENT), SENT), "min")
    relp = stat_of("ts_aid_rel_pos_in_session")
    cols2["sum_rel_pos"] = (masked(torch.where(relp == NULL, 0, relp), 0), "sum")

    for t in range(n_cov):
        cnt = masked(red1[f"cov{t}_count"], 0)
        cols2[f"cov{t}_count"] = (cnt, "sum")
        for f in ("count_pop", "perc_pop", "count_rel"):
            cols2[f"cov{t}_num_{f}"] = (masked(red1[f"cov{t}_{f}"], 0) * cnt, "sum")
        rk = red1[f"cov{t}_rank"]
        cols2[f"cov{t}_num_rank"] = (
            masked(torch.where(rk == SENT, 0, rk), 0) * cnt, "sum")

    for kind in ("w2v_all", "w2v_12"):
        rk = red1[f"{kind}_rank"]
        present = keep & (rk != SENT)
        cols2[f"{kind}_n"] = (present.to(I32), "sum")
        cols2[f"{kind}_sum_rank"] = (torch.where(present, rk, 0), "sum")
        cols2[f"{kind}_best_rank"] = (masked(rk, SENT), "min")
        cols2[f"{kind}_sum_dist"] = (
            torch.where(present, red1[f"{kind}_dist"], 0.0), "sum")

    # self features ride as (is_self ? stat : identity)
    self_keep = is_self & keep

    def slf(name, red, ident, null_dst=None):
        a = stat_of(name)
        if null_dst is not None:
            a = _null_to(a, NULL, null_dst)
        return (torch.where(self_keep, a, ident), red)

    cols2["slf_present"] = (self_keep.to(I32), "sum")
    cols2["slf_n"] = slf("n_aid", "sum", 0)
    cols2["slf_n_clicks"] = slf("n_aid_clicks", "sum", 0)
    cols2["slf_n_carts"] = slf("n_aid_carts", "sum", 0)
    cols2["slf_n_orders"] = slf("n_aid_orders", "sum", 0)
    cols2["slf_rank_by_n"] = slf("rank_by_n_aid", "min", SENT, SENT)
    cols2["slf_rank_by_n_carts"] = slf("rank_by_n_aid_carts", "min", SENT, SENT)
    cols2["slf_rank_by_n_orders"] = slf("rank_by_n_aid_orders", "min", SENT, SENT)
    cols2["slf_max_ts"] = slf("max_ts_aid", "max", NEG_SENT, NEG_SENT)
    cols2["slf_max_ts_clicks"] = slf("max_ts_aid_clicks", "max", NEG_SENT, NEG_SENT)
    cols2["slf_max_ts_carts"] = slf("max_ts_aid_carts", "max", NEG_SENT, NEG_SENT)
    cols2["slf_max_ts_orders"] = slf("max_ts_aid_orders", "max", NEG_SENT, NEG_SENT)
    cols2["slf_ts_rel_pos"] = slf("ts_aid_rel_pos_in_session", "min", SENT, SENT)
    cols2["slf_ts_order"] = slf("ts_order_aid", "min", SENT, SENT)
    cols2["slf_ts_order_rel"] = slf("ts_order_aid_rel", "min", SENT, SENT)
    cols2["slf_ts_order_clicks"] = slf("ts_order_aid_clicks", "min", SENT, SENT)
    cols2["slf_ts_order_carts"] = slf("ts_order_aid_carts", "min", SENT, SENT)
    cols2["slf_ts_order_orders"] = slf("ts_order_aid_orders", "min", SENT, SENT)
    cols2["slf_left_in_cart"] = slf("left_in_cart", "sum", 0)

    # popularity candidates appended as extra entries (outer join); only
    # the top-20-by-any-rank ones are kept
    T_pop = ctx.pop_cl50_cand.shape[1]
    gc = cluster.clamp(0, ctx.pop_cl50_cand.shape[0] - 1).long()
    pop_cand = ctx.pop_cl50_cand[gc]                 # [S, T]
    pop_ranks = ctx.pop_cl50_ranks[gc]               # [S, T, 6]
    pop_valid = (pop_cand >= 0) & (pop_ranks.amin(dim=2) <= 20)

    key2 = torch.cat([key2_main, torch.where(pop_valid, pop_cand, SENT)], dim=1)

    def pad_main(arr, ident):
        return torch.cat([arr, torch.full_like(arr[:, :1], ident).expand(S, T_pop)], dim=1)

    cols2p = {
        n: (pad_main(a, seg._reduce_identity(a.dtype, red)), red)
        for n, (a, red) in cols2.items()
    }
    del cols2
    for pi in range(6):
        pr = torch.where(pop_valid, pop_ranks[:, :, pi], SENT)
        cols2p[f"pop_{pi}"] = (torch.cat([full((S, P1), SENT), pr], dim=1), "min")
    cols2p["pop_present"] = (
        torch.cat([full((S, P1), 0), pop_valid.to(I32)], dim=1), "sum")
    return key2, cols2p


def _stage_e(pk, moved, idents, ss, ctx, ses_emb, max_candidates):
    """Stage E after the transport sort: one K7 launch for a batch on the
    card, its twin _features_program elsewhere."""
    if pk.device.type == "cuda":
        return k7.retrieval_features(
            pk, [moved[n] for n in k7.COLUMNS], [getattr(ss, n) for n in k7.STATS],
            ctx.pop_cl1_rank, ctx.aid_emb, ses_emb, max_candidates)
    return _features_program(pk, moved, idents, ss, ctx, ses_emb, max_candidates)


def _features_program(pk, moved, idents, ss, ctx, ses_emb, max_candidates):
    """K7's plain twin (ops/kernels/retrieval_features.py): the features of
    the C kept lanes from the sorted keys pk [S, C] and the moved columns
    {name: [S, C]} (cand, ts_order and the Stage D reductions; an empty
    slot takes its reducer's identity from `idents`), the session stats
    `ss`, the popularity ranks and the embeddings. -> (cand [S,
    max_candidates] int32 (-1 pad), feats [S, max_candidates, F] float32,
    ts_order [S, max_candidates] int32)."""
    C = pk.shape[1]
    slot_ok = pk != SENT
    cand = torch.where(slot_ok, moved["cand"], -1)
    valid = cand >= 0
    ts_order_c = torch.where(slot_ok, moved["ts_order"], SENT)
    r2: Dict[str, torch.Tensor] = {
        n: torch.where(slot_ok, moved[n], ident) for n, ident in idents.items()
    }

    # ---------------- final feature assembly --------------------------------
    f: Dict[str, torch.Tensor] = {}
    valid_f = valid.to(F32)

    def out_i(name, arr, null_ident=None, null_val=NULL):
        x = arr if null_ident is None else _null_to(arr, null_ident, null_val)
        f[name] = torch.where(valid, x, null_val).to(F32)

    # session-level (broadcast)
    for name, arr in (
        ("n_events_session", ss.n_events), ("n_aids_session", ss.n_aids),
        ("n_clicks_session", ss.n_clicks), ("n_carts_session", ss.n_carts),
        ("n_orders_session", ss.n_orders), ("duration_session", ss.duration),
        ("only_orders_session", ss.only_orders),
    ):
        f[name] = arr[:, None].to(F32) * valid_f

    max_ts_s = ss.max_ts[:, None]
    min_ts_s = ss.min_ts[:, None]
    span1 = (ss.max_ts - ss.min_ts + 1)[:, None].to(F32)

    # self
    out_i("slf_n", r2["slf_n"])
    out_i("slf_n_clicks", r2["slf_n_clicks"])
    out_i("slf_n_carts", r2["slf_n_carts"])
    out_i("slf_n_orders", r2["slf_n_orders"])
    out_i("slf_rank_by_n", r2["slf_rank_by_n"], SENT)
    out_i("slf_rank_by_n_carts", r2["slf_rank_by_n_carts"], SENT)
    out_i("slf_rank_by_n_orders", r2["slf_rank_by_n_orders"], SENT)
    for suff in ("", "_clicks", "_carts", "_orders"):
        mts = r2[f"slf_max_ts{suff}"]
        out_i(f"slf_since_ts{suff}",
              torch.where(mts == NEG_SENT, NULL, max_ts_s - mts))
    out_i("slf_ts_rel_pos_in_session", r2["slf_ts_rel_pos"], SENT)
    out_i("slf_ts_order", r2["slf_ts_order"], SENT)
    out_i("slf_ts_order_rel", r2["slf_ts_order_rel"], SENT)
    out_i("slf_ts_order_clicks", r2["slf_ts_order_clicks"], SENT)
    out_i("slf_ts_order_carts", r2["slf_ts_order_carts"], SENT)
    out_i("slf_ts_order_orders", r2["slf_ts_order_orders"], SENT)
    out_i("slf_left_in_cart", r2["slf_left_in_cart"])

    # aggregates
    n_uniq_f = r2["n_uniq_aid"].clamp(min=1).to(F32)
    for name in ("n_uniq_aid", "n_uniq_aid_clicks", "n_uniq_aid_carts",
                 "n_uniq_aid_orders", "n_aid", "n_aid_clicks", "n_aid_carts",
                 "n_aid_orders"):
        out_i(name, r2[name])

    for suff in ("", "_clicks", "_carts", "_orders"):
        mts = r2[f"max_ts_aid{suff}"]
        out_i(f"since_ts_aid{suff}",
              torch.where(mts == NEG_SENT, NULL, max_ts_s - mts))

    mt_max = r2["max_ts_aid"]
    has_mt = mt_max != NEG_SENT
    out_i("since_session_start_ts_aid",
          torch.where(has_mt, mt_max - min_ts_s, NULL))
    mto_max = r2["max_ts_aid_orders"]
    out_i("since_session_start_ts_aid_orders",
          torch.where(mto_max != NEG_SENT, mto_max - min_ts_s, NULL))
    out_i("rel_pos_max_ts_aid_in_session",
          torch.where(has_mt,
                      ((mt_max - min_ts_s).to(F32) / span1 * 100).to(I32), NULL))
    # sums are session-start-relative, so mean - min_ts == sum_rel / n; the
    # two divisions are taken as one by (n * span), as XLA's algebraic
    # simplifier rewrites otto_tpu's (sum / n) / span
    rel_mt = r2["sum_rel_max_ts_aid"].to(F32) / (n_uniq_f * span1)
    out_i("rel_pos_mean_max_ts_aid_in_session",
          torch.where(has_mt, (rel_mt * 100).to(I32), NULL))
    cnt_o = r2["cnt_max_ts_aid_orders"]
    rel_mto = r2["sum_rel_max_ts_aid_orders"].to(F32) / (
        cnt_o.clamp(min=1).to(F32) * span1)
    out_i("rel_pos_mean_max_ts_aid_orders_in_session",
          torch.where(cnt_o > 0, (rel_mto * 100).to(I32), NULL))

    # ts_order_aid: candidates only from popularity get 999
    f["ts_order_aid"] = torch.where(valid, ts_order_c.clamp(0, 999), NULL).to(F32)
    out_i("ts_order_aid_rel", r2["ts_order_aid_rel"], SENT)
    out_i("ts_order_aid_clicks", r2["ts_order_aid_clicks"], SENT)
    out_i("ts_order_aid_carts", r2["ts_order_aid_carts"], SENT)
    out_i("ts_order_aid_orders", r2["ts_order_aid_orders"], SENT)
    mean_rp = (r2["sum_rel_pos"].to(F32) / n_uniq_f).to(I32)
    out_i("ts_aid_rel_pos_in_session",
          torch.where(r2["n_uniq_aid"] > 0, mean_rp, NULL))
    out_i("rank_by_n_aid", r2["rank_by_n_aid"], SENT)

    # co-vis: count-weighted means; absent -> -1
    for t, name in enumerate(COVIS_NAMES):
        cnt = r2[f"cov{t}_count"]
        has = cnt > 0
        out_i(f"{name}_count", torch.where(has, cnt, NULL))
        for ff in ("count_pop", "perc_pop", "count_rel", "rank"):
            mean_v = (r2[f"cov{t}_num_{ff}"].to(F32)
                      / cnt.clamp(min=1).to(F32)).to(I32)
            out_i(f"{name}_{ff}", torch.where(has, mean_v, NULL))

    # w2vec aggregates; absent -> -1
    for kind, out_suff in (("w2v_all", "all"), ("w2v_12", "1_2")):
        n = r2[f"{kind}_n"]
        has = n > 0
        n_f = n.clamp(min=1).to(F32)
        out_i(f"n_w2vec_{out_suff}", n)
        mean_d = torch.where(has, r2[f"{kind}_sum_dist"] / n_f, NULL)
        f[f"dist_w2vec_{out_suff}"] = torch.where(valid, mean_d, NULL).to(F32)
        mean_r = (r2[f"{kind}_sum_rank"].to(F32) / n_f).to(I32)
        out_i(f"rank_w2vec_{out_suff}", torch.where(has, mean_r, NULL))
        out_i(f"best_rank_w2vec_{out_suff}",
              torch.where(has, r2[f"{kind}_best_rank"], NULL))

    # source flags
    f["src_any"] = valid_f
    f["src_self"] = (valid & (r2["slf_present"] > 0)).to(F32)
    for t, name in enumerate(COVIS_NAMES):
        n_t = r2["n_aid_clicks"] if t in (0, 1) else (
            r2["n_aid_carts"] if t in (2, 3) else r2["n_aid_orders"]
        )
        f[f"src_{name}"] = (
            valid & (n_t > 0) & (r2[f"cov{t}_count"] > 0)
        ).to(F32)
    f["src_w2vec_all"] = (valid & (r2["w2v_all_n"] > 0)).to(F32)
    f["src_w2vec_1_2"] = (valid & (r2["w2v_12_n"] > 0)).to(F32)
    f["src_pop_cl50"] = (valid & (r2["pop_present"] > 0)).to(F32)

    # popularity ranks
    for pi, pname in enumerate(POP_RANK_NAMES):
        out_i(f"{pname}_cl50", r2[f"pop_{pi}"], SENT)
    gcand = cand.clamp(min=0).long()
    cl1 = ctx.pop_cl1_rank[gcand]
    for pi, pname in enumerate(("rank_clicks_cl1", "rank_carts_cl1", "rank_orders_cl1")):
        f[pname] = torch.where(valid, cl1[:, :, pi], NULL).to(F32)

    # embedding similarity
    cand_vec = ctx.aid_emb[gcand]                        # [S, C, D]
    dot = torch.einsum("sd,scd->sc", ses_emb, cand_vec)
    n_s = torch.linalg.norm(ses_emb, dim=1)[:, None]
    n_c = torch.linalg.norm(cand_vec, dim=2)
    del cand_vec
    cos = dot / torch.clamp(n_s * n_c, min=1e-9)
    eucl = torch.sqrt(torch.clamp(n_s**2 + n_c**2 - 2 * dot, min=0.0))
    has_emb = valid & (n_c > 1e-9)
    f["cos_sim_ses_aid"] = torch.where(has_emb, cos, 0.0).to(F32)
    f["eucl_dist_ses_aid"] = torch.where(has_emb, eucl, NULL).to(F32)

    # heuristic prior: self recency boost + summed normalized co-visit mass
    heur = torch.where(r2["slf_present"] > 0,
                       10.0 / torch.clamp(f["slf_ts_order"], min=1.0), 0.0)
    for name in COVIS_NAMES:
        crel = f[f"{name}_count_rel"]
        heur = heur + torch.where(crel > 0, crel / 100.0, 0.0)
    f["heur_score"] = torch.where(valid, heur, 0.0).to(F32)

    feats = torch.stack([f[name] for name in FEATURE_NAMES], dim=2)
    ts_out = ts_order_c.clamp(0, 999)
    if C < max_candidates:
        # keep the [S, max_candidates] output contract when the cap exceeds
        # this bucket's lane width (batches of different buckets concatenate)
        pad = max_candidates - C
        cand = torch.nn.functional.pad(cand, (0, pad), value=-1)
        feats = torch.nn.functional.pad(feats, (0, 0, 0, pad))
        ts_out = torch.nn.functional.pad(ts_out, (0, pad), value=999)
    return cand, feats, ts_out


# ---------------------------------------------------------------------------
# Host loop
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SessionLookup:
    """Sorted-array session -> (cluster, embedding) join: one vectorized
    searchsorted per batch (otto_tpu.engine.retrieval.SessionLookup)."""

    ids: np.ndarray       # [n] sorted unique session ids
    cluster: np.ndarray   # [n] int32 cl50 assignment
    emb: np.ndarray       # [n, D] float32 session embeddings

    @staticmethod
    def build(ids: np.ndarray, cluster: np.ndarray, emb: np.ndarray) -> "SessionLookup":
        ids = np.asarray(ids)
        order = np.argsort(ids, kind="stable")
        return SessionLookup(
            ids=ids[order],
            cluster=np.asarray(cluster, np.int32)[order],
            emb=np.asarray(emb, np.float32)[order],
        )

    @staticmethod
    def from_dicts(cluster: Dict[int, int], emb: Dict[int, np.ndarray],
                   dim: int) -> "SessionLookup":
        """From {session: cluster} and {session: embedding} (a session in
        only one of them gets cluster 0 / a zero embedding)."""
        ids = np.array(sorted(set(cluster) | set(emb)), np.int64)
        cl = np.array([cluster.get(int(s), 0) for s in ids], np.int32)
        em = np.stack([
            np.asarray(emb.get(int(s), np.zeros(dim, np.float32)), np.float32)
            for s in ids
        ]) if len(ids) else np.zeros((0, dim), np.float32)
        return SessionLookup(ids=ids, cluster=cl, emb=em)

    def lookup(self, sessions: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized join; misses get cluster 0 / zero embedding."""
        if len(self.ids) == 0:
            return (
                np.zeros(len(sessions), np.int32),
                np.zeros((len(sessions), self.emb.shape[1]), np.float32),
            )
        pos = np.clip(np.searchsorted(self.ids, sessions), 0, len(self.ids) - 1)
        hit = self.ids[pos] == sessions
        cl = np.where(hit, self.cluster[pos], 0).astype(np.int32)
        em = np.where(hit[:, None], self.emb[pos], 0.0).astype(np.float32)
        return cl, em


@dataclasses.dataclass
class Retriever:
    """Host-side loop: streams padded session batches through
    retrieve_batch on the context's device.

    With `mesh` (a parallel.mesh.MeshContext; every data rank iterating
    the same sessions), the microbatches are dealt round-robin over the
    data ranks, each retrieved whole: every batch has the shape it has on
    one device, so a session's candidates and features are those of a
    one-device run bit for bit (a share of a batch would put the float
    features' products through the card's BLAS at another batch size)."""

    ctx: RetrievalContext
    cfg: RetrievalConfig
    sessions: SessionLookup              # session -> (cl50, embedding)
    mesh: Optional[object] = None        # parallel.mesh.MeshContext

    def run(
        self,
        test: Events,
        batch_sessions: int = 256,
        keep_aids: Optional[int] = None,
        max_candidates: Optional[int] = None,
    ) -> List[RetrievedBatch]:
        """Every batch of iter_run in one list: every batch's [S, C, F]
        features stay on the device at once (~213 KB a session at C = 512),
        as the batch runner keeps them."""
        return list(self.iter_run(test, batch_sessions, keep_aids, max_candidates))

    def iter_run(
        self,
        test: Events,
        batch_sessions: int = 256,
        keep_aids: Optional[int] = None,
        max_candidates: Optional[int] = None,
    ):
        """Yield one RetrievedBatch per microbatch of each length bucket
        (with a mesh: those dealt to this data rank, batch g to data rank
        g % n_data), each with its `index` g in one device's order. A
        bucket's tail batch is padded to the bucket's batch size with
        session -1 rows, which `keep` filters out."""
        keep_aids = keep_aids or self.cfg.max_session_aids
        max_candidates = max_candidates or self.cfg.max_candidates
        dev = self.ctx.aid_emb.device
        cfg = self.cfg

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        # spans close before each yield: the time the caller holds a batch
        # is not retrieval's
        with timing.span("otto::retrieval.pack"):
            trim = torch.tensor(
                [
                    cfg.trim_max_at_order_1,
                    cfg.trim_min,
                    (cfg.trim_max_at_order_1 - cfg.trim_min)
                    / (cfg.trim_min_at_order - 1),
                ],
                dtype=F32, device=dev,
            )
            packed = pack_sessions(test, cfg.session_len_buckets)
        n_batches = 0
        for p in packed:
            size = min(batch_sessions, p.n_sessions)
            for mb in iter_microbatches(p, size):
                n_batches += 1
                if self.mesh is not None and (n_batches - 1) % self.mesh.n_data \
                        != self.mesh.data_rank:
                    continue
                with timing.span("otto::retrieval.batch", n_batches - 1):
                    with timing.span("otto::retrieval.lookup"):
                        cluster, semb = self.sessions.lookup(mb.session)
                    with timing.span("otto::retrieval.h2d"):
                        padded = (put(mb.aid), put(mb.ts), put(mb.type))
                        cluster, semb = put(cluster), put(semb)
                    cand, feats, ts_order = retrieve_batch(
                        padded, self.ctx, cluster, semb, trim, keep_aids, max_candidates,
                    )
                    with timing.span("otto::retrieval.keep"):
                        keep = mb.session >= 0
                        keep_idx = None if bool(keep.all()) else np.nonzero(keep)[0]
                        batch = RetrievedBatch(
                            session=mb.session[keep],
                            cand=cand,
                            feats=feats if keep_idx is None
                            else feats[torch.as_tensor(keep_idx, device=dev)],
                            ts_order=ts_order,
                            keep=keep_idx,
                            index=n_batches - 1,
                            history=padded,
                        )
                yield batch


def join_labels(batches: List[RetrievedBatch], labels) -> List[np.ndarray]:
    """Per batch, [S, C, 3] float32 0/1 targets: candidate c of session s
    is a type-t label (the label join of the batch runner, on the host, on
    the 45-bit keys of label_keys_device)."""
    by_type = {}
    for tid in (0, 1, 2):
        lab = labels.for_type(tid)
        by_type[tid] = np.sort(lab.session.astype(np.int64) << AID_BITS
                               | lab.aid.astype(np.int64))
    out = []
    for b in batches:
        cand = b.cand
        tgt = np.zeros(cand.shape + (3,), np.float32)
        key = (b.session.astype(np.int64)[:, None] << AID_BITS) | np.maximum(
            cand, 0).astype(np.int64)
        for tid, srt in by_type.items():
            if len(srt) == 0:
                continue
            pos = np.searchsorted(srt, key)
            hit = (pos < len(srt)) & (srt[np.minimum(pos, len(srt) - 1)] == key)
            tgt[:, :, tid] = (hit & (cand >= 0)).astype(np.float32)
        out.append(tgt)
    return out
