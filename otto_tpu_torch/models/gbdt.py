"""Histogram-GBDT lambdarank ranker: training and prediction.

Counterpart of otto_tpu/models/gbdt.py. Trees are dense arrays: split
feature gfeat [T, D, W] and split bin thr [T, D, W] (thr == n_bins is a
no-op split that sends every row left), leaf values leaf [T, 2^D],
W = 2^(D-1). `save` and `load` read and write otto_tpu's `.npz`. A ranker
is checked when it is made: K1 reads the split features' bins unchecked,
so a split feature out of range would read out of bounds on the card.

Training follows otto_tpu's `_train_core`: bin edges are quantiles of
the rows (numpy, on the host), the rows are binned to uint8 on the device
and grouped by session into `max_group` slots (positives first), the
groups padded to a `group_chunk` multiple; every tree
draws a column subset and a row bag, takes exact pairwise LambdaRank
gradients over the groups (ndcg@k-weighted, per-query normalised), and
grows a complete depth-D tree level by level from per-level histograms.
The boosting loop is an eager loop over trees and levels on the device
with no host round-trip inside a tree.

Histograms and leaf sums, as in otto_tpu, take gradients, hessians and
counts rounded to bfloat16. The port sums them exactly: each column is
scaled by a power of two into int64 fixed point (headroom for every row)
and summed with integer `index_add_`, into 32 replicas of each cell on
the card so that hot cells do not serialise; the exact sums are rounded
once to float32. Integer sums do not depend on the order of the adds, so
the card's histograms equal the CPU's on the same inputs and a training
on the card repeats bit for bit.

Data-parallel training (`mesh_ctx`, otto_tpu's `_train_program_dp`):
every rank bins, routes and sums a contiguous share of the session groups
(their count padded to group_chunk x n_data), and the fixed-point scale
(largest value and row count), the histograms and the leaf sums are
all-reduced: int64 sums, so the trees do not depend on how the groups are
split. The scores are all-gathered after each tree and every rank takes
the lambda gradients of all groups in one device's chunks, then its own
share: on the card a reduction's order can depend on the batch it runs
in. Every rank grows the same trees from one device's column subset and
row bag (`one_device_draws`; otto_tpu bags each shard's rows on its own),
so a data-parallel training gives one device's ranker.

Prediction on the card is one launch of kernel K5 a ranker
(`ops/kernels/gbdt_walk.py`): it bins, walks every tree and sums the
leaves of each row in one pass. Its plain twin, which serves CPU tensors
bit for bit as otto_tpu does, bins the raw features (bin = number of
edges <= x), then walks all trees at once: node state is [M, T], and at
every level the per-row feature-bin fetch is ONE row gather [M, F] ->
[M, T] on kernel K1 (the training's validation scores walk that way on
the card too).
"""
from __future__ import annotations

import ast
import dataclasses
import logging
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from otto_tpu_torch.config import GBDTConfig
from otto_tpu_torch.models.ranker import _group_slots, ndcg_at_k
from otto_tpu_torch.ops.kernels.gather import gather_rows
from otto_tpu_torch.ops.kernels.gbdt_walk import gbdt_walk

log = logging.getLogger(__name__)

# float32(1 / ln 2): XLA compiles otto_tpu's jnp.log2(x) as log(x) times
# this constant (a division by the constant ln 2, made a multiplication)
LOG2E = 1.44269502
# replicas of every histogram cell on the card (row n adds into replica
# n % HIST_REPLICAS); one on the CPU, where adds do not contend
HIST_REPLICAS = 32
# session groups per lambda-gradient call on the card
CUDA_LAMBDA_GROUPS = 1 << 14
# rows per binning call
BIN_ROWS = 1 << 20


# ---------------------------------------------------------------------------
# host-side quantile binning (numpy copies of otto_tpu's)
# ---------------------------------------------------------------------------

def compute_bin_edges(
    feats: np.ndarray, n_bins: int, sample: int = 1 << 20, seed: int = 0
) -> np.ndarray:
    """[N, F] float -> [F, n_bins-1] ascending bin edges (quantiles);
    duplicate quantiles collapse and the tail pads with +inf."""
    n, f = feats.shape
    if n > sample:
        idx = np.random.default_rng(seed).choice(n, sample, replace=False)
        feats = feats[idx]
    feats = feats.astype(np.float32, copy=False)
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    edges = np.quantile(feats, qs, axis=0).T.astype(np.float32)  # [F, B-1]
    out = np.full_like(edges, np.inf)
    for j in range(f):
        u = np.unique(edges[j])
        u = u[np.isfinite(u)]
        out[j, : len(u)] = u
    return out


def bin_features(feats: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """[N, F] float, [F, B-1] edges -> [N, F] uint8 bin ids (edge <= x
    count), one binary search per value."""
    n, f = feats.shape
    out = np.empty(feats.shape, np.uint8)
    for j in range(f):
        out[:, j] = np.searchsorted(
            edges[j], feats[:, j].astype(np.float32), side="right"
        ).astype(np.uint8)
    return out


# ---------------------------------------------------------------------------
# lambdarank gradients
# ---------------------------------------------------------------------------

def _log2(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x) * LOG2E


def _lambda_grads_chunk(scores, labels, mask, maxdcg, sigma, k, norm, n_lead=None):
    """scores/labels [C, G] f32, mask [C, G] bool, maxdcg [C] -> grad,
    hess [C, G]. Ranks break score ties by slot (a stable sort), as
    jnp.argsort does: at the first tree every score is 0.

    With labels >= 0 only a positive slot can win a pair; n_lead says that
    no slot past the first n_lead holds a positive, and the pairs are taken
    over [C, n_lead, G] instead of [C, G, G] (the same gradients)."""
    C, G = scores.shape
    P = G if n_lead is None else n_lead
    s = torch.where(mask, scores, -torch.inf)
    order = torch.argsort(-s, dim=1, stable=True)
    slots = torch.arange(G, device=scores.device).expand(C, G)
    rank = torch.empty_like(order).scatter_(1, order, slots)
    disc = torch.where(rank < k, 1.0 / _log2(2.0 + rank.to(torch.float32)), 0.0)
    delta = (disc[:, :P, None] - disc[:, None, :]).abs() / maxdcg.clamp(
        min=1e-9)[:, None, None]

    y = torch.where(mask, labels, 0.0)
    win = (y[:, :P, None] > y[:, None, :]) & mask[:, :P, None] & mask[:, None, :]
    sd = scores[:, :P, None] - scores[:, None, :]
    # jax.nn.sigmoid(-sigma * sd) as XLA expands it: 1 / (1 + exp(-x))
    rho = 1.0 / (1.0 + torch.exp(-(sd * -sigma)))
    lam = torch.where(win, sigma * rho * delta, 0.0)        # [C, P, G]
    hes = torch.where(win, sigma * sigma * rho * (1.0 - rho) * delta, 0.0)

    # winners pushed up: grad = -lam.sum(2) + lam.sum(1), hess likewise
    grad = lam.sum(1)
    hess = hes.sum(1)
    grad[:, :P] = -lam.sum(2) + grad[:, :P]
    hess[:, :P] = hes.sum(2) + hess[:, :P]
    if norm:
        sum_l = lam.abs().sum(dim=(1, 2))           # per-query |lambda| mass
        scale = torch.where(
            sum_l > 0, _log2(1.0 + sum_l) / sum_l.clamp(min=1e-12), 0.0
        )[:, None]
        grad = grad * scale
        hess = hess * scale
    return grad, hess


def _max_dcg(labels: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """Ideal DCG@k per group, [NG, G] -> [NG]."""
    G = labels.shape[1]
    n_pos = (labels * mask).sum(1)
    pos = torch.arange(G, dtype=torch.float32, device=labels.device)[None, :]
    disc = torch.where(
        pos < n_pos.clamp(max=float(k))[:, None], 1.0 / _log2(2.0 + pos), 0.0
    )
    return disc.sum(1)


# ---------------------------------------------------------------------------
# exact sums of bfloat16 operands
# ---------------------------------------------------------------------------

def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e as float32 for integer e in [-126, 127], built from its bits."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _fixed_point(v: torch.Tensor, mesh_ctx=None):
    """v [N, K] f32 -> (q [N, K] int64, unit [K] f32) with v ~ q * unit:
    each column is scaled by a power of two so that its largest |v| takes
    62 - bit_length(N) bits, which leaves a sum of N values room in int64.
    bfloat16 values down to 2^-30 of the column's largest are exact. With
    `mesh_ctx`, N and the largest |v| are those of every rank's rows."""
    n = v.shape[0]
    amax = v.abs().amax(0) if n else v.new_zeros(v.shape[1:])   # a rank may hold no rows
    if mesh_ctx is not None:
        n = int(mesh_ctx.all_sum(torch.tensor(n, device=v.device)))
        mesh_ctx.all_max(amax)
    headroom = 62 - max(1, n).bit_length()
    _, e = torch.frexp(amax)                         # max |v| < 2^e
    s = (headroom - e).clamp(-126, 126)
    q = torch.round(v * _pow2(s)).to(torch.int64)
    return q, _pow2(-s)


def _cell_sums(cell: torch.Tensor, q: torch.Tensor, n_cells: int) -> torch.Tensor:
    """Exact per-cell sums of the rows of q: cell [N] int64 in [0, n_cells),
    q [N, K] int64 -> [n_cells, K] int64."""
    n, k = q.shape
    reps = HIST_REPLICAS if q.device.type == "cuda" else 1
    if reps > 1:
        lane = torch.arange(n, device=q.device) % reps
        cell = cell * reps + lane
    out = torch.zeros((n_cells * reps, k), dtype=torch.int64, device=q.device)
    out.index_add_(0, cell, q)
    return out.view(n_cells, reps, k).sum(1)


def _histograms_fixed(bins_sub, node, q, n_nodes_w, n_bins) -> torch.Tensor:
    """bins_sub [N, Fs] uint8 | int, node [N] int64, q [N, 3] int64 ->
    [Fs, n_bins, W, 3] int64 sums per (feature, bin, node)."""
    n, fs = bins_sub.shape
    out = torch.empty((fs, n_bins * n_nodes_w, q.shape[1]), dtype=torch.int64,
                      device=q.device)
    for f in range(fs):
        out[f] = _cell_sums(bins_sub[:, f].long() * n_nodes_w + node, q,
                            n_bins * n_nodes_w)
    return out.view(fs, n_bins, n_nodes_w, q.shape[1])


def _histograms(bins_sub, node, gh3, n_nodes_w, n_bins) -> torch.Tensor:
    """bins_sub [N, Fs], node [N], gh3 [N, 3] f32 -> [Fs, n_bins, W*3] f32
    (otto_tpu's layout): per (feature, bin, node) sums of the bfloat16-
    rounded grad, hess and count, exact, rounded once to float32."""
    q, unit = _fixed_point(_bf16(gh3))
    h = _histograms_fixed(bins_sub, node.long(), q, n_nodes_w, n_bins)
    return (h.to(torch.float32) * unit).reshape(bins_sub.shape[1], n_bins, -1)


# ---------------------------------------------------------------------------
# tree building
# ---------------------------------------------------------------------------

def _build_tree(bins_sub, grad, hess, cnt, cfg: GBDTConfig, mesh_ctx=None):
    """One complete depth-D tree, level-wise.

    bins_sub [N, Fs] (feature-subsampled bins), grad/hess/cnt [N] f32 (0
    for bagged-out rows). Returns (feat_local [D, W], thr [D, W], gain
    [D, W], leaf [2^D], node [N]); thr == n_bins is a no-op split. With
    `mesh_ctx` the rows are this rank's, and histograms and leaf sums are
    all-reduced over the data ranks."""
    depth, n_bins = cfg.max_depth, cfg.n_bins
    W = 1 << (depth - 1)
    n_leaves = 1 << depth
    dev = grad.device
    N = bins_sub.shape[0]
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    feat_arr = torch.zeros((depth, W), dtype=torch.int64, device=dev)
    thr_arr = torch.full((depth, W), n_bins, dtype=torch.int64, device=dev)
    gain_arr = torch.zeros((depth, W), dtype=torch.float32, device=dev)
    q, unit = _fixed_point(_bf16(torch.stack([grad, hess, cnt], dim=-1)), mesh_ctx)
    slot = torch.arange(W, device=dev)
    l2 = cfg.lambda_l2
    for level in range(depth):
        H = _histograms_fixed(bins_sub, node, q, W, n_bins)
        if mesh_ctx is not None:
            mesh_ctx.all_sum(H)
        H = H.to(torch.float32) * unit
        cum = torch.cumsum(H, dim=1)                   # left stats for thr=b+1
        tot = cum[:, -1:, :, :]
        gl, hl, cl = cum[..., 0], cum[..., 1], cum[..., 2]
        gt, ht, ct = tot[..., 0], tot[..., 1], tot[..., 2]
        gr, hr, cr = gt - gl, ht - hl, ct - cl
        gain = (
            gl * gl / (hl + l2 + 1e-9)
            + gr * gr / (hr + l2 + 1e-9)
            - gt * gt / (ht + l2 + 1e-9)
        )
        ok = (
            (cl >= cfg.min_child_samples)
            & (cr >= cfg.min_child_samples)
            & (hl >= cfg.min_child_hessian)
            & (hr >= cfg.min_child_hessian)
        )
        gain = torch.where(ok, gain, -torch.inf)        # [Fs, B, W]
        flat = gain.reshape(-1, W)                      # [(Fs*B), W]
        best = flat.argmax(dim=0)                       # first maximum
        best_gain = flat.gather(0, best[None, :])[0]
        do_split = (best_gain > 1e-12) & (slot < (1 << level))
        thr = torch.where(do_split, best % n_bins + 1, n_bins)
        bf = torch.where(do_split, best // n_bins, 0)
        feat_arr[level] = bf
        thr_arr[level] = thr
        gain_arr[level] = torch.where(do_split, best_gain, 0.0)
        # route: go right iff the row's bin of its node's feature >= thr
        row_bin = bins_sub.gather(1, bf[node][:, None].to(torch.int64))[:, 0]
        node = node * 2 + (row_bin.long() >= thr[node]).long()

    sums = _cell_sums(node, q, n_leaves)
    if mesh_ctx is not None:
        mesh_ctx.all_sum(sums)
    sums = sums.to(torch.float32) * unit
    leaf = torch.where(
        sums[:, 2] > 0,
        -sums[:, 0] / (sums[:, 1] + l2 + 1e-9) * cfg.learning_rate,
        0.0,
    )
    return feat_arr, thr_arr, gain_arr, leaf, node


# ---------------------------------------------------------------------------
# the boosting loop
# ---------------------------------------------------------------------------

def _pad_axis0(x: np.ndarray, mult: int, fill=0) -> np.ndarray:
    n = x.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return x
    return np.concatenate([x, np.full((pad, *x.shape[1:]), fill, x.dtype)])


Draws = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def tree_draws(cfg: GBDTConfig, n_features: int, n_rows: int, device) -> Draws:
    """The default per-tree draws of one device: t -> (feat_idx [Fs], bag
    [n_rows] bool), a column subset of Fs = round(colsample * F) features
    and a Bernoulli (subsample) row bag, from a torch.Generator on `device`
    seeded with (cfg.seed, t). Other draws than otto_tpu's threefry
    stream."""
    dev = torch.device(device)
    n_sub = max(1, int(round(cfg.colsample * n_features)))

    def draws(t: int):
        g = torch.Generator(device=dev).manual_seed(cfg.seed * 1_000_003 + int(t))
        feat_idx = torch.randperm(n_features, generator=g, device=dev)[:n_sub]
        bag = torch.rand(n_rows, generator=g, device=dev) < cfg.subsample
        return feat_idx, bag

    return draws


def one_device_draws(cfg: GBDTConfig, n_features: int, rows_one: int, rows_all: int,
                     n_data: int, device) -> Draws:
    """The default draws of data-parallel training: (t, shard) -> tree t's
    column subset and row bag as tree_draws gives them over one device's
    `rows_one` grouped rows, the bag padded with False to the `rows_all`
    rows of n_data ranks' layout (the same groups in the same slots, more
    padding groups) and cut into the ranks' equal shares; every rank draws
    the whole bag, one [rows_one] draw a tree."""
    base = tree_draws(cfg, n_features, rows_one, device)
    share = rows_all // n_data

    def draws(t: int, shard: int):
        feat_idx, bag = base(t)
        bag = torch.cat([bag, bag.new_zeros(rows_all - rows_one)])
        return feat_idx, bag[shard * share:(shard + 1) * share]

    return draws


def _train_core(bins, labels_g, mask_g, cfg: GBDTConfig, draws: Draws, scores0=None,
                tree_ids=None, mesh_ctx=None):
    """bins [NG*G, F] uint8 (grouped-flat: row g*G+j <-> group g slot j),
    labels_g [NG, G] f32, mask_g [NG, G] bool, NG a multiple of
    cfg.group_chunk, all on one device. Grows the trees `tree_ids` (all
    n_trees by default) from scores0 (zeros) and returns the stacked trees
    (gfeat, thr, gain [T, D, W], leaf [T, 2^D]) and the final scores.

    `draws(t) -> (feat_idx [Fs], bag [NG*G])` gives tree t's column subset
    and row bag (train_gbdt_ranker's default: `tree_draws`). Padded slots
    take no part: they have no gradient, so only real rows are binned,
    routed and summed.

    With `mesh_ctx`, labels_g / mask_g are every rank's groups, bins and
    scores0 this data rank's share of them (NG / n_data groups), draws are
    called as draws(t, data rank), and every rank returns the same trees
    (and the scores of its own rows)."""
    NG, G = labels_g.shape
    N = bins.shape[0]
    dev = bins.device
    maxdcg = _max_dcg(labels_g, mask_g, cfg.ndcg_at)
    # per-group work: a chunk's size changes no group's gradients
    chunk = CUDA_LAMBDA_GROUPS if dev.type == "cuda" else cfg.group_chunk
    lead = ((labels_g > 0) & mask_g).any(0).nonzero()
    n_lead = int(lead.max()) + 1 if len(lead) else 1
    own = slice(0, N)   # this rank's rows of the grouped-flat layout
    if mesh_ctx is not None:
        own = slice(mesh_ctx.data_rank * N, (mesh_ctx.data_rank + 1) * N)
    rows = mask_g.reshape(-1)[own].nonzero()[:, 0]
    bins_r = bins[rows]
    scores = torch.zeros(N, device=dev) if scores0 is None else scores0.clone()
    if tree_ids is None:
        tree_ids = range(cfg.n_trees)
    gfeat, thr, gain, leaf = [], [], [], []
    for t in tree_ids:
        feat_idx, bag = draws(t) if mesh_ctx is None else draws(t, mesh_ctx.data_rank)
        sc = (scores if mesh_ctx is None else mesh_ctx.gather_data(scores)).view(NG, G)
        grad = torch.empty((NG, G), device=dev)
        hess = torch.empty((NG, G), device=dev)
        for c0 in range(0, NG, chunk):
            sl = slice(c0, c0 + chunk)
            grad[sl], hess[sl] = _lambda_grads_chunk(
                sc[sl], labels_g[sl], mask_g[sl], maxdcg[sl],
                cfg.sigma, cfg.ndcg_at, cfg.lambda_norm, n_lead)
        bag_r = bag.to(dev)[rows].to(torch.float32)
        feat_idx = feat_idx.to(dev).long()
        f_l, th, gn, lf, node = _build_tree(
            bins_r[:, feat_idx], grad.view(-1)[own][rows] * bag_r,
            hess.view(-1)[own][rows] * bag_r, bag_r, cfg, mesh_ctx)
        scores[rows] += lf[node]
        gfeat.append(feat_idx[f_l])
        thr.append(th)
        gain.append(gn)
        leaf.append(lf)
    return (torch.stack(gfeat), torch.stack(thr), torch.stack(gain),
            torch.stack(leaf), scores)


# ---------------------------------------------------------------------------
# prediction
# ---------------------------------------------------------------------------

def _bin_program(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """x [M, F] f32, edges [F, B-1] ascending -> [M, F] int32 bin ids, the
    count of edges <= x per feature (otto_tpu's `_bin_program`, whose
    edges come ascending from `compute_bin_edges`, +inf padded)."""
    b = torch.searchsorted(edges.contiguous(), x.t().contiguous(), right=True)
    # row-major, as K1 reads it at every level of the walk
    return b.to(torch.int32).t().contiguous()


def _leaf_values(
    bins: torch.Tensor, gfeat: torch.Tensor, thr: torch.Tensor, leaf: torch.Tensor
) -> torch.Tensor:
    """bins [M, F] int32; gfeat/thr [T, D, W] int32, leaf [T, 2^D] f32 ->
    the leaf value each row reaches in each tree, [M, T] f32."""
    M = bins.shape[0]
    T, depth, W = gfeat.shape
    n_leaves = leaf.shape[1]
    tree = torch.arange(T, device=bins.device, dtype=torch.int32)[None, :]
    node = torch.zeros((M, T), dtype=torch.int32, device=bins.device)
    for level in range(depth):
        # this level's (feature, threshold) of each row's node in each tree
        at = (tree * W + node).long()
        f = gfeat[:, level, :].reshape(-1)[at]
        t_thr = thr[:, level, :].reshape(-1)[at]
        b = gather_rows(bins[None], f)[0]
        node = node * 2 + (b >= t_thr).to(torch.int32)
    return leaf.reshape(-1)[(tree * n_leaves + node).long()]


def _predict_binned_program(
    bins: torch.Tensor, gfeat: torch.Tensor, thr: torch.Tensor, leaf: torch.Tensor
) -> torch.Tensor:
    """bins [M, F] int32; gfeat/thr [T, D, W] int32, leaf [T, 2^D] f32 ->
    scores [M] f32."""
    return _leaf_values(bins, gfeat, thr, leaf).sum(dim=1)


def _predict_program(x, edges, gfeat, thr, leaf) -> torch.Tensor:
    """Fused bin + traverse: raw features [M, F] f32 -> scores [M]."""
    return _predict_binned_program(_bin_program(x, edges), gfeat, thr, leaf)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GBDTRanker:
    """Trained GBDT lambdarank model. The numpy arrays are the model as
    `save` writes it; the tensor copies used for scoring are made per
    device on first use."""

    cfg: GBDTConfig
    edges: np.ndarray        # [F, B-1] bin edges
    gfeat: np.ndarray        # [T, D, W] split feature (global id)
    thr: np.ndarray          # [T, D, W] split bin threshold (n_bins = no-op)
    leaf: np.ndarray         # [T, 2^D] leaf values
    feature_names: Tuple[str, ...]
    gains: Optional[np.ndarray] = None  # [T, D, W] split gains (0 = no-op)
    best_iter: int = -1                 # -1 = unknown (len(leaf) trees)
    best_score: float = float("nan")    # valid ndcg@k at best_iter
    # (trees so far, valid ndcg@k) at each eval point of training
    eval_history: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list, repr=False, compare=False
    )
    _on_device: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    def __post_init__(self):
        T = np.shape(self.gfeat)[0]
        D, n_bins = self.cfg.max_depth, self.cfg.n_bins
        F = len(self.feature_names)
        shapes = {"edges": (F, n_bins - 1), "gfeat": (T, D, 2 ** (D - 1)),
                  "thr": (T, D, 2 ** (D - 1)), "leaf": (T, 2 ** D)}
        for name, want in shapes.items():
            if np.shape(getattr(self, name)) != want:
                raise ValueError(f"ranker {name} has shape "
                                 f"{np.shape(getattr(self, name))}, want {want}")
        gfeat, thr = np.asarray(self.gfeat), np.asarray(self.thr)
        if gfeat.size and not (gfeat.min() >= 0 and gfeat.max() < F):
            raise ValueError(f"ranker split features outside [0, {F})")
        # thr == n_bins is the no-op split
        if thr.size and not (thr.min() >= 1 and thr.max() <= n_bins):
            raise ValueError(f"ranker split bins outside [1, {n_bins}]")
        # binning counts edges by binary search (K5 compares one edge a
        # split): both need each feature's edges ascending
        edges = np.asarray(self.edges)
        if np.isnan(edges).any() or not (edges[:, 1:] >= edges[:, :-1]).all():
            raise ValueError("ranker bin edges are NaN or not ascending")

    def tensors(self, device: torch.device):
        """(edges f32, gfeat i32, thr i32, leaf f32) on `device`, cached,
        contiguous as K5 takes them (trained edges come column-major from
        `compute_bin_edges`)."""
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = tuple(
                torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)
                for a, dtype in ((self.edges, np.float32), (self.gfeat, np.int32),
                                 (self.thr, np.int32), (self.leaf, np.float32)))
        return self._on_device[key]

    def predict_scores_device(self, feats: torch.Tensor) -> torch.Tensor:
        """feats [..., F] on a device -> scores [...] on the same device:
        K5 on a CUDA tensor, the plain twin elsewhere."""
        shape = feats.shape[:-1]
        flat = feats.reshape(-1, feats.shape[-1]).to(torch.float32)
        if flat.device.type == "cuda":
            scores = gbdt_walk(flat.contiguous(), *self.tensors(feats.device))
        else:
            scores = _predict_program(flat, *self.tensors(feats.device))
        return scores.reshape(shape)

    def predict(self, feats: np.ndarray, device, batch: int = 1 << 16) -> np.ndarray:
        """Host rows [N, F] -> scores [N]: binned on the host, walked on
        `device` in batches of `batch` rows."""
        dev = torch.device(device)
        bins = bin_features(np.asarray(feats, np.float32), self.edges)
        _, gfeat, thr, leaf = self.tensors(dev)
        out = np.empty(len(bins), np.float32)
        for i in range(0, len(bins), batch):
            x = torch.from_numpy(bins[i: i + batch].astype(np.int32)).to(dev)
            out[i: i + batch] = _predict_binned_program(x, gfeat, thr, leaf).cpu().numpy()
        return out

    def feature_importance(self, importance_type: str = "gain") -> np.ndarray:
        """Per-feature importance: 'gain' sums split gains, 'split' counts
        splits (gain falls back to split without recorded gains)."""
        used = self.thr < self.cfg.n_bins
        n_feats = len(self.feature_names)
        if importance_type == "gain" and self.gains is not None:
            return np.bincount(
                self.gfeat[used].reshape(-1),
                weights=self.gains[used].reshape(-1),
                minlength=n_feats,
            )
        return np.bincount(
            self.gfeat[used].reshape(-1), minlength=n_feats
        ).astype(np.int64)

    def save(self, path: str) -> None:
        """The `.npz` layout of otto_tpu's GBDTRanker.save."""
        np.savez_compressed(
            path,
            edges=self.edges,
            gfeat=self.gfeat,
            thr=self.thr,
            leaf=self.leaf,
            gains=(
                self.gains
                if self.gains is not None
                else np.zeros((0,), np.float32)
            ),
            feature_names=np.array(self.feature_names),
            best=np.array([float(self.best_iter), self.best_score], np.float64),
            cfg=np.frombuffer(
                repr(dataclasses.asdict(self.cfg)).encode(), dtype=np.uint8
            ),
        )

    @staticmethod
    def load(path: str) -> "GBDTRanker":
        """Read a ranker that otto_tpu's or the port's `save` wrote."""
        z = np.load(path, allow_pickle=False)
        cfg = GBDTConfig.from_dict(
            ast.literal_eval(bytes(z["cfg"].tobytes()).decode()))
        gains = z["gains"] if "gains" in z.files else np.zeros((0,), np.float32)
        best = z["best"] if "best" in z.files else np.array([-1.0, np.nan])
        return GBDTRanker(
            cfg=cfg,
            edges=z["edges"],
            gfeat=z["gfeat"],
            thr=z["thr"],
            leaf=z["leaf"],
            gains=gains if gains.size else None,
            feature_names=tuple(z["feature_names"].tolist()),
            best_iter=int(best[0]),
            best_score=float(best[1]),
        )


# ---------------------------------------------------------------------------
# training entry point
# ---------------------------------------------------------------------------

def _cap_groups(f, y, s, cap, seed, tag):
    u = np.unique(s)
    if not cap or len(u) <= cap:
        return f, y, s
    keep_s = np.random.default_rng(seed).choice(u, cap, replace=False)
    m = np.isin(s, keep_s)
    log.info("gbdt %s: capping %d groups (%d rows) to %d groups (%d rows)",
             tag, len(u), len(s), cap, int(m.sum()))
    return f[m], y[m], s[m]


def _grouped_bins(feats, labels, sessions, edges_d, cfg: GBDTConfig, dev, group_mult):
    """Rows -> otto_tpu's grouped layout on `dev`: bins [NG*G, F] uint8
    (grouped-flat, G = cfg.max_group, NG padded to a group_mult multiple),
    labels [NG, G] f32 and mask [NG, G] bool. The rows are binned on the
    device (the same bins as bin_features) and placed where _group_pad
    puts them."""
    rows, slots, n_groups = _group_slots(labels, sessions, cfg.max_group)
    n_slots = (n_groups + (-n_groups) % group_mult) * cfg.max_group
    F = feats.shape[1]
    binned = torch.empty((len(feats), F), dtype=torch.uint8, device=dev)
    for i in range(0, len(feats), BIN_ROWS):
        x = torch.from_numpy(np.ascontiguousarray(feats[i: i + BIN_ROWS])).to(dev)
        binned[i: i + BIN_ROWS] = _bin_program(x.to(torch.float32), edges_d)
    slots_d = torch.from_numpy(slots).to(dev)
    rows_d = torch.from_numpy(rows).to(dev)
    bins = torch.zeros((n_slots, F), dtype=torch.uint8, device=dev)
    bins[slots_d] = binned[rows_d]
    lg = torch.zeros(n_slots, dtype=torch.float32, device=dev)
    lg[slots_d] = torch.from_numpy(np.asarray(labels, np.float32)).to(dev)[rows_d]
    mg = torch.zeros(n_slots, dtype=torch.bool, device=dev)
    mg[slots_d] = True
    return bins, lg.view(-1, cfg.max_group), mg.view(-1, cfg.max_group)


def train_gbdt_ranker(
    feats: np.ndarray,           # [N, F] flat candidate rows
    labels: np.ndarray,          # [N] 0/1 target for one type
    group_sessions: np.ndarray,  # [N] session id per row
    feature_names: Tuple[str, ...],
    cfg: GBDTConfig = GBDTConfig(),
    valid: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    *,
    device,
    draws: Optional[Draws] = None,
    mesh_ctx=None,
) -> GBDTRanker:
    """Bin the rows, group them by session and boost cfg.n_trees trees on
    `device`, as otto_tpu's train_gbdt_ranker does on one device.

    Groups past cfg.max_train_groups (valid: max_valid_groups) are capped
    by a seeded draw. With `valid` (feats, labels, sessions), valid
    ndcg@cfg.ndcg_at is taken every cfg.eval_every trees (and after the
    last), from scores accumulated eval chunk by eval chunk; best_iter /
    best_score record the best point, and cfg.early_stopping_rounds > 0
    stops once it is that many trees behind and keeps the best trees.
    `draws` replaces the per-tree column / row draws (see _train_core).

    With `mesh_ctx` (every data rank calling with the same rows), training
    is data-parallel: the group count is padded to group_chunk x n_data,
    each rank boosts on its contiguous share of the groups from one
    device's draws (one_device_draws, unless `draws` is given), and every
    rank returns one device's ranker (the valid set is scored on every
    rank)."""
    dev = torch.device(device)
    feats, labels, group_sessions = _cap_groups(
        feats, labels, group_sessions, cfg.max_train_groups, cfg.seed, "train")
    if valid is not None:
        valid = _cap_groups(*valid, cfg.max_valid_groups, cfg.seed, "valid")
    edges = compute_bin_edges(feats, cfg.n_bins, seed=cfg.seed)
    edges_d = torch.from_numpy(edges).to(dev)
    n_dev = 1 if mesh_ctx is None else mesh_ctx.n_data
    bins, lg_d, mg_d = _grouped_bins(feats, labels, group_sessions, edges_d, cfg, dev,
                                     group_mult=cfg.group_chunk * n_dev)
    if draws is None and mesh_ctx is None:
        draws = tree_draws(cfg, feats.shape[1], bins.shape[0], dev)
    elif draws is None:
        n_groups = int(mg_d.any(dim=1).sum())
        rows_one = (n_groups + (-n_groups) % cfg.group_chunk) * cfg.max_group
        draws = one_device_draws(cfg, feats.shape[1], rows_one, bins.shape[0], n_dev, dev)
    if n_dev > 1:   # this rank's share of the groups' rows
        bins = bins[mesh_ctx.data_slice(bins.shape[0])]

    eval_every = cfg.eval_every if valid is not None and cfg.eval_every > 0 else 0
    chunk = eval_every or cfg.n_trees
    if valid is not None:
        vbins, vlg, vmg = _grouped_bins(*valid, edges_d, cfg, dev, group_mult=1)
        vbins = vbins.to(torch.int32)
        vlg, vmg = vlg.cpu().numpy(), vmg.cpu().numpy()
        vscores = torch.zeros(vbins.shape[0], device=dev)

    scores = None
    parts = []
    evals: List[Tuple[int, float]] = []
    best_iter, best_score = -1, -np.inf
    n_done = 0
    for t0 in range(0, cfg.n_trees, chunk):
        tids = range(t0, min(t0 + chunk, cfg.n_trees))
        gf, th, gn, lf, scores = _train_core(
            bins, lg_d, mg_d, cfg, draws, scores0=scores, tree_ids=tids,
            mesh_ctx=mesh_ctx)
        parts.append((gf, th, gn, lf))
        n_done = tids[-1] + 1
        if valid is None:
            continue
        # the chunk's trees summed first, then added (otto_tpu's order)
        vscores = vscores + _predict_binned_program(
            vbins, gf.to(torch.int32), th.to(torch.int32), lf)
        ndcg = ndcg_at_k(vscores.view(vlg.shape).cpu().numpy(), vlg, vmg, cfg.ndcg_at)
        evals.append((n_done, ndcg))
        log.info("gbdt [%d] valid ndcg@%d=%.5f", n_done, cfg.ndcg_at, ndcg)
        if ndcg > best_score:
            best_iter, best_score = n_done, ndcg
        elif cfg.early_stopping_rounds > 0 and n_done - best_iter >= cfg.early_stopping_rounds:
            log.info("gbdt early stop at %d trees (best iter %d, ndcg@%d=%.5f)",
                     n_done, best_iter, cfg.ndcg_at, best_score)
            break
    gfeat, thr, gains, leaf = (
        torch.cat([p[i] for p in parts]).cpu().numpy() for i in range(4))
    gfeat, thr = gfeat.astype(np.int32), thr.astype(np.int32)
    if best_iter < 0:
        best_iter = n_done   # no valid set: every tree
    elif cfg.early_stopping_rounds > 0 and best_iter < len(leaf):
        gfeat, thr = gfeat[:best_iter], thr[:best_iter]
        gains, leaf = gains[:best_iter], leaf[:best_iter]
    return GBDTRanker(
        cfg=cfg, edges=edges, gfeat=gfeat, thr=thr, leaf=leaf, gains=gains,
        feature_names=tuple(feature_names), best_iter=best_iter,
        best_score=float(best_score) if np.isfinite(best_score) else float("nan"),
        eval_history=evals,
    )
