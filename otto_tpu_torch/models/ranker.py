"""The LambdaRank MLP ranker (C16/C17), the ndcg@k eval metric and session
grouping.

Counterpart of otto_tpu/models/ranker.py: `ranker_backend="mlp"` scores
candidates with this tower. A session is one listwise group; the loss is
LambdaRank's pairwise logistic loss weighted by |delta NDCG@k|; one tower
is trained per target type on pass A's rows.

The tower (`RankerTower`, otto_tpu's RankerParams with `score` as its
forward) log-squashes and normalises its inputs, optionally appends each
candidate's offset from its group's mean and max, and runs ReLU layers
whose products take bfloat16 operands and whose outputs are float32.
The casts are written where otto_tpu's are, so autograd rounds the
gradients where XLA's transposes do: the weights' and the activations'
gradients arrive rounded to bfloat16, the biases' in float32.

The card and the CPU agree to the bit: each layer's products of
bfloat16 values and its bias are summed in float64 (exact for these
widths, whatever the order), the log-squash and the group means are taken
in float64, each rounded once to float32, and the loss is taken in
float64, so its gradients reach the tower rounded alike. Summed in
float32, the two devices' orders (and their float32 log1p and exp) differ
by ulps; an ulp at a bfloat16 rounding boundary moves an activation or a
gradient by a bfloat16 ulp, and Adam's normalised first steps turn an
ulp in a gradient near zero into a step of up to the learning rate.

Training follows otto_tpu's `train_ranker`: norm stats from the first 2^20
rows, groups padded to `max_group` (positives first), a numpy permutation
of the groups each epoch, AdamW under optax's warmup-cosine schedule
(`lr_schedule`), valid ndcg@k after each epoch, the best epoch's weights
kept, early stop. The initial weights come from a torch.Generator (He
normal), not from jax's threefry: tests inject otto_tpu's through
`init_ranker`. `Ranker.save` and `load` read and write otto_tpu's `.npz`.
"""
from __future__ import annotations

import copy
import ctypes
import ctypes.util
import dataclasses
import logging
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from otto_tpu_torch.config import RankerConfig

log = logging.getLogger(__name__)

F32 = torch.float32
F64 = torch.float64
BF16 = torch.bfloat16
# float32(1 / ln 2): XLA compiles otto_tpu's jnp.log2(x) as log(x) times
# this constant
LOG2E = 1.44269502
# session groups scored at once by predict_grouped and the valid eval
EVAL_GROUPS = 1 << 12


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------

def _log_squash(x: torch.Tensor) -> torch.Tensor:
    """Sign-preserving log compression of heavy-tailed features, float32
    correctly rounded: taken in float64 and rounded once, so that the card
    and the CPU (whose float32 log1p differ by ulps) give the same bits."""
    x = x.to(F64)
    return (torch.sign(x) * torch.log1p(torch.abs(x))).to(F32)


def compute_norm_stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-feature mean and std of the log-squashed rows (std < 1e-6 -> 1),
    in float32; otto_tpu's numpy function."""
    x = np.asarray(feats, np.float32)
    x = np.sign(x) * np.log1p(np.abs(x))
    mean = x.mean(axis=0)
    std = x.std(axis=0)
    std = np.where(std < 1e-6, 1.0, std)
    return mean.astype(np.float32), std.astype(np.float32)


class RankerTower(nn.Module):
    """The scoring MLP: buffers `norm_mean`, `norm_std` [F] and `src_idx`
    (the src_* flags' feature indices, or None), parameters `w[i]` [in,
    out] and `b[i]` [out] per layer (otto_tpu's layout). With src_idx the
    axis before F is the candidate group and the input is listwise."""

    def __init__(self, norm_mean, norm_std, weights, src_idx=None):
        super().__init__()
        self.register_buffer("norm_mean", torch.tensor(np.asarray(norm_mean, np.float32)))
        self.register_buffer("norm_std", torch.tensor(np.asarray(norm_std, np.float32)))
        self.register_buffer("src_idx", None if src_idx is None else
                             torch.tensor(np.asarray(src_idx, np.int64)))
        self.w = nn.ParameterList(
            [nn.Parameter(torch.tensor(np.asarray(w, np.float32))) for w, _ in weights])
        self.b = nn.ParameterList(
            [nn.Parameter(torch.tensor(np.asarray(b, np.float32))) for _, b in weights])

    def forward(self, feats: torch.Tensor, dropout: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """feats [..., F] float32 -> scores [...] (otto_tpu's `score`).
        dropout > 0 (training only) drops hidden activations with inverted
        scaling, drawn from `generator`."""
        x = (_log_squash(feats) - self.norm_mean) / self.norm_std
        if self.src_idx is not None:
            valid = (feats[..., self.src_idx] > 0).sum(-1) > 0        # [..., G]
            vf = valid[..., None].to(F32)
            n_valid = torch.clamp(vf.sum(-2, keepdim=True), min=1.0)
            # a float64 sum, rounded once: the same bits on either device
            g_mean = ((x.to(F64) * vf).sum(-2, keepdim=True) / n_valid).to(F32)
            g_max = torch.where(vf > 0, x, -torch.inf).amax(-2, keepdim=True)
            g_max = torch.where(torch.isfinite(g_max), g_max, 0.0)
            x = torch.cat([x, x - g_mean, x - g_max], dim=-1)
        x = x.to(BF16)
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = (torch.matmul(x.to(F64), w.to(BF16).to(F64)) + b.to(F64)).to(F32)
            if i < n - 1:
                x = torch.relu(x)
                if dropout > 0.0:
                    keep = torch.rand(x.shape, generator=generator,
                                      device=x.device) < 1.0 - dropout
                    x = torch.where(keep, x / (1.0 - dropout), 0.0)
                x = x.to(BF16)
        return x[..., 0]

    def weights(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """[(w, b)] per layer as numpy float32."""
        return [(w.detach().cpu().numpy(), b.detach().cpu().numpy())
                for w, b in zip(self.w, self.b)]


def init_ranker(
    n_features: int,
    cfg: RankerConfig,
    feat_mean: np.ndarray,
    feat_std: np.ndarray,
    seed: Optional[int] = None,
    src_idx: Optional[np.ndarray] = None,
) -> RankerTower:
    """A fresh tower on the CPU: He-normal weights drawn from a CPU
    torch.Generator seeded with `seed` (default cfg.seed), zero biases."""
    g = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    in_dim = n_features * (3 if src_idx is not None else 1)
    dims = [in_dim, *cfg.hidden_dims, 1]
    weights = []
    for i in range(len(dims) - 1):
        w = torch.randn((dims[i], dims[i + 1]), generator=g) * math.sqrt(2.0 / dims[i])
        weights.append((w.numpy(), np.zeros(dims[i + 1], np.float32)))
    return RankerTower(feat_mean, feat_std, weights, src_idx)


# ---------------------------------------------------------------------------
# the loss and one step
# ---------------------------------------------------------------------------

class _Softplus(torch.autograd.Function):
    """jax.nn.softplus as XLA runs it: logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|)) (F.softplus turns into the identity above 20), and
    its custom derivative exp(x - softplus(x)), +inf read as 0."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(torch.where(x == torch.inf, 0.0, x)
                             - torch.where(out == torch.inf, 0.0, out))


def _inv_log2_2p(x: torch.Tensor) -> torch.Tensor:
    """1 / log2(2 + x), with log2 as XLA compiles it."""
    return 1.0 / (torch.log(2.0 + x) * LOG2E)


def _lambdarank_loss(
    tower: RankerTower,
    feats: torch.Tensor,     # [B, G, F]
    labels: torch.Tensor,    # [B, G] float 0/1
    mask: torch.Tensor,      # [B, G] bool
    sigma: float,
    k: int,
    dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Mean over the valid pairs with y_i > y_j of |delta NDCG@k| *
    softplus(-sigma * (s_i - s_j)), in float64 (module docstring); ranks
    from a stable descending sort of the scores (masked candidates score
    -1e9, so padding keeps slot order)."""
    s = tower(feats, dropout, generator).to(F64)
    s = torch.where(mask, s, -1e9)
    B, G = s.shape
    order = torch.argsort(-s, dim=1, stable=True)
    slots = torch.arange(G, device=s.device)
    rank = torch.empty_like(order).scatter_(1, order, slots.expand(B, G))
    disc = torch.where(rank < k, _inv_log2_2p(rank.to(F64)), 0.0)

    n_pos = (labels * mask).sum(1)
    ideal_pos = slots.to(F64)[None, :]
    ideal_disc = torch.where(ideal_pos < torch.clamp(n_pos, max=k)[:, None],
                             _inv_log2_2p(ideal_pos), 0.0)
    max_dcg = torch.clamp(ideal_disc.sum(1), min=1e-9)

    y = torch.where(mask, labels, 0.0)
    pair_pos = (y[:, :, None] > y[:, None, :]) & mask[:, :, None] & mask[:, None, :]
    delta_ndcg = torch.abs(disc[:, :, None] - disc[:, None, :]) / max_dcg[:, None, None]
    s_diff = s[:, :, None] - s[:, None, :]
    pair_loss = _Softplus.apply(-sigma * s_diff) * delta_ndcg
    loss = torch.where(pair_pos, pair_loss, 0.0).sum()
    n_pairs = torch.clamp(pair_pos.sum().to(F64), min=1.0)
    return loss / n_pairs


def make_optimizer(tower: RankerTower, cfg: RankerConfig) -> torch.optim.AdamW:
    """optax.adamw(schedule, weight_decay) over every weight and bias: its
    betas and eps, decay scaled by the learning rate. The rate is set
    before each step (lr_schedule)."""
    return torch.optim.AdamW(tower.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def lr_schedule(cfg: RankerConfig, total_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule as train_ranker builds it (0 ->
    learning_rate over max(1, int(total_steps * warmup_frac)) steps, then
    cosine to end_lr_frac * learning_rate by total_steps), in the float32
    arithmetic XLA compiles it to: divisions by constants become products
    with their reciprocals, constant factors fold, pow(x, 1.0) goes and a
    product plus a term is one fused multiply-add; cos is the C library's
    cosf, which XLA's CPU code calls.
    -> the rate of the update that follows `step` updates: optax reads its
    count before adding one, so the first update's rate is 0 and moves
    only the moments."""
    f32, f64 = np.float32, np.float64
    peak = cfg.learning_rate
    end = cfg.learning_rate * cfg.end_lr_frac
    warmup = max(1, int(total_steps * cfg.warmup_frac))
    decay = total_steps - warmup
    if decay <= 0:
        raise ValueError(f"{total_steps} steps leave no cosine decay after "
                         f"{warmup} warmup steps")
    alpha = 0.0 if peak == 0.0 else end / peak
    inv_warmup = f32(1) / f32(warmup)
    phase = f32(np.pi) * (f32(1) / f32(decay))
    scale = f32(1 - alpha) * f32(0.5)
    cosf = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").cosf
    cosf.argtypes, cosf.restype = [ctypes.c_float], ctypes.c_float

    def fma(a, b, c):
        # float32 a * b + c rounded once, as XLA's CPU code contracts it
        return f32(f64(a) * f64(b) + f64(c))

    def lr(step: int) -> float:
        if step < warmup:
            frac = fma(f32(max(step, 0)), -inv_warmup, f32(1))
            return float(fma(frac, f32(0.0 - peak), f32(peak)))
        cosine = f32(cosf(min(f32(step - warmup), f32(decay)) * phase))
        return float(fma(cosine + f32(1), scale, f32(alpha)) * f32(peak))

    return lr


def train_step(
    tower: RankerTower,
    optimizer: torch.optim.Optimizer,
    batch: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    lr: float,
    sigma: float,
    k: int,
    dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """One AdamW step on the weights at learning rate `lr` from one batch
    (feats [B, G, F], labels [B, G], mask [B, G]). -> the loss (on the
    device, no sync)."""
    feats, labels, mask = batch
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.zero_grad(set_to_none=True)
    loss = _lambdarank_loss(tower, feats, labels, mask, sigma, k, dropout, generator)
    loss.backward()
    optimizer.step()
    return loss.detach()


# ---------------------------------------------------------------------------
# the trained ranker
# ---------------------------------------------------------------------------

def ndcg_at_k(
    scores: np.ndarray, labels: np.ndarray, mask: np.ndarray, k: int = 20
) -> float:
    """Mean NDCG@k over the groups [NG, G] with at least one positive."""
    s = np.where(mask, scores, -np.inf)
    y = np.where(mask, labels, 0.0)
    k = min(k, s.shape[1])
    order = np.argsort(-s, axis=1)[:, :k]
    top_y = np.take_along_axis(y, order, axis=1)
    disc = 1.0 / np.log2(2.0 + np.arange(k))
    dcg = (top_y * disc[None, :]).sum(axis=1)
    n_pos = y.sum(axis=1).astype(np.int64)
    has_pos = n_pos > 0
    ideal = np.array(
        [disc[: min(n, k)].sum() if n > 0 else 1.0 for n in n_pos]
    )
    return float((dcg[has_pos] / ideal[has_pos]).mean()) if has_pos.any() else 0.0


@dataclasses.dataclass
class Ranker:
    """A trained per-target MLP ranker. `history` holds (epoch, last
    loss, valid ndcg@eval_at or None) per epoch run, `best_epoch` the
    epoch whose weights were kept (-1: the last, without a valid set) and
    `steps` the steps taken; none of them is saved."""

    cfg: RankerConfig
    tower: RankerTower
    feature_names: Tuple[str, ...]
    best_epoch: int = -1
    steps: int = 0
    history: List[Tuple[int, float, Optional[float]]] = dataclasses.field(
        default_factory=list, repr=False, compare=False)
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def tower_on(self, device: torch.device) -> RankerTower:
        """The tower on `device`: itself where it lives, else a copy made
        on first use."""
        device = torch.device(device)
        if self.tower.norm_mean.device == device:
            return self.tower
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = copy.deepcopy(self.tower).to(device)
        return self._on_device[key]

    def predict_scores_device(self, feats: torch.Tensor) -> torch.Tensor:
        """feats [..., F] on a device -> scores [...] on the same device."""
        with torch.no_grad():
            return self.tower_on(feats.device)(feats.to(F32))

    def predict(self, feats: np.ndarray, device, batch: int = 1 << 16) -> np.ndarray:
        """Host rows [N, F] -> scores [N], scored pointwise on `device`."""
        if self.tower.src_idx is not None:
            raise ValueError("group-context ranker scores listwise; use predict_grouped"
                             " with [n_groups, group, F] input")
        return self._predict(feats, device, batch)

    def predict_grouped(self, feats: np.ndarray, device, batch: int = EVAL_GROUPS
                        ) -> np.ndarray:
        """Host groups [n_groups, G, F] -> scores [n_groups, G] on `device`."""
        return self._predict(feats, device, batch)

    def _predict(self, feats, device, batch):
        dev = torch.device(device)
        out = np.empty(feats.shape[:-1], np.float32)
        for i in range(0, feats.shape[0], batch):
            x = torch.from_numpy(np.asarray(feats[i: i + batch], np.float32)).to(dev)
            out[i: i + batch] = self.predict_scores_device(x).cpu().numpy()
        return out

    def save(self, path: str) -> None:
        """The `.npz` layout of otto_tpu's Ranker.save."""
        t = self.tower
        flat = {"norm_mean": t.norm_mean.cpu().numpy(),
                "norm_std": t.norm_std.cpu().numpy(),
                "feature_names": np.array(self.feature_names)}
        if t.src_idx is not None:
            flat["src_idx"] = t.src_idx.cpu().numpy().astype(np.int32)
        for i, (w, b) in enumerate(t.weights()):
            flat[f"w{i}"] = w
            flat[f"b{i}"] = b
        np.savez_compressed(path, **flat)

    @staticmethod
    def load(path: str, cfg: RankerConfig) -> "Ranker":
        """Read a ranker that otto_tpu's or the port's `save` wrote (the
        tower on the CPU)."""
        z = np.load(path, allow_pickle=False)
        n_layers = len([k for k in z.files if k.startswith("w")])
        tower = RankerTower(z["norm_mean"], z["norm_std"],
                            [(z[f"w{i}"], z[f"b{i}"]) for i in range(n_layers)],
                            z["src_idx"] if "src_idx" in z.files else None)
        return Ranker(cfg, tower, tuple(z["feature_names"].tolist()))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _grouped_scores(tower: RankerTower, fg: torch.Tensor) -> np.ndarray:
    """Scores of padded groups [n_groups, G, F] on their device, EVAL_GROUPS
    at a time."""
    with torch.no_grad():
        return torch.cat([tower(fg[i: i + EVAL_GROUPS])
                          for i in range(0, fg.shape[0], EVAL_GROUPS)]).cpu().numpy()


def train_ranker(
    feats: np.ndarray,           # [N, F] flat candidate rows
    labels: np.ndarray,          # [N] 0/1 target for one type
    group_sessions: np.ndarray,  # [N] session id per row
    feature_names: Tuple[str, ...],
    cfg: RankerConfig = RankerConfig(),
    valid: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    *,
    device,
) -> Ranker:
    """Group the rows by session, pad the groups to cfg.max_group and train
    a tower on `device`, as otto_tpu's train_ranker does: batches of
    min(batch_sessions, n_groups) groups in a seeded numpy permutation
    each epoch, AdamW under lr_schedule, and with `valid` (feats, labels,
    sessions) valid ndcg@eval_at after each epoch, the best epoch's
    weights kept and an early stop after early_stop_epochs epochs without
    a better one. The padded groups stay on the device."""
    dev = torch.device(device)
    feats = np.asarray(feats, np.float32)
    mean, std = compute_norm_stats(feats[: 1 << 20])
    src_idx = None
    if cfg.group_context:
        src_idx = np.asarray(
            [i for i, n in enumerate(feature_names) if n.startswith("src_")], np.int32)
        if len(src_idx) == 0:
            src_idx = None
    tower = init_ranker(feats.shape[1], cfg, mean, std, src_idx=src_idx).to(dev)

    fg, lg, mg = _group_pad(feats, labels, group_sessions, cfg.max_group)
    n_groups = fg.shape[0]
    fg, lg, mg = (torch.from_numpy(a).to(dev) for a in (fg, lg, mg))
    rng = np.random.default_rng(cfg.seed)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    # fewer groups than the configured batch: a smaller batch, so that an
    # epoch still takes a step
    B = min(cfg.batch_sessions, n_groups)
    steps_per_epoch = max(1, n_groups // B)
    lr = lr_schedule(cfg, steps_per_epoch * cfg.epochs)
    optimizer = make_optimizer(tower, cfg)

    vpack = None
    if valid is not None:
        vf, vl, vs = valid
        vfg, vlg, vmg = _group_pad(np.asarray(vf, np.float32), vl, vs, cfg.max_group)
        vpack = (torch.from_numpy(vfg).to(dev), vlg, vmg)

    history: List[Tuple[int, float, Optional[float]]] = []
    best_ndcg, best_state, best_epoch = -1.0, None, -1
    step = 0
    loss = torch.zeros((), device=dev)
    for epoch in range(cfg.epochs):
        perm = torch.from_numpy(rng.permutation(n_groups)).to(dev)
        for i in range(0, n_groups - B + 1, B):
            sel = perm[i: i + B]
            loss = train_step(tower, optimizer, (fg[sel], lg[sel], mg[sel]), lr(step),
                              cfg.sigma, cfg.eval_at, float(cfg.dropout), gen)
            step += 1
        ndcg = None
        if vpack is not None:
            ndcg = ndcg_at_k(_grouped_scores(tower, vpack[0]), vpack[1], vpack[2],
                             cfg.eval_at)
        history.append((epoch, float(loss), ndcg))
        log.info("ranker epoch %d: loss=%.5f%s", epoch, history[-1][1],
                 "" if ndcg is None else f" valid ndcg@{cfg.eval_at}={ndcg:.5f}")
        if ndcg is None:
            continue
        if ndcg > best_ndcg:
            best_ndcg, best_epoch = ndcg, epoch
            best_state = {k: v.detach().clone() for k, v in tower.state_dict().items()}
        elif cfg.early_stop_epochs and epoch - best_epoch >= cfg.early_stop_epochs:
            log.info("ranker early stop after epoch %d (best epoch %d, ndcg %.5f)",
                     epoch, best_epoch, best_ndcg)
            break
    if best_state is not None:
        tower.load_state_dict(best_state)
    return Ranker(cfg, tower, tuple(feature_names), best_epoch=best_epoch, steps=step,
                  history=history)


# ---------------------------------------------------------------------------
# session grouping
# ---------------------------------------------------------------------------

def _group_slots(labels, sessions, max_group):
    """Where `_group_pad` puts each row: -> (rows [K], slots [K] =
    group * max_group + position, n_groups); rows past max_group in their
    group are left out."""
    order = np.lexsort((-labels, sessions))
    s_s = sessions[order]
    u_sess, starts = np.unique(s_s, return_index=True)
    gi = np.searchsorted(u_sess, s_s)
    pos = np.arange(len(s_s)) - starts[gi]
    keep = pos < max_group
    return order[keep], gi[keep] * max_group + pos[keep], len(u_sess)


def _group_pad(feats, labels, sessions, max_group):
    """[N, F] rows -> ([n_groups, max_group, F] features, [n_groups,
    max_group] labels, mask), one group per session in ascending session
    order. A group longer than max_group keeps its positives first."""
    rows, slots, n_g = _group_slots(labels, sessions, max_group)
    F = feats.shape[1]
    # uint8 bins and float16 rows pad in their own dtype
    fdt = feats.dtype if feats.dtype in (np.uint8, np.float16) else np.float32
    fg = np.zeros((n_g * max_group, F), fdt)
    lg = np.zeros(n_g * max_group, np.float32)
    mg = np.zeros(n_g * max_group, bool)
    fg[slots] = feats[rows]
    lg[slots] = labels[rows]
    mg[slots] = True
    return (fg.reshape(n_g, max_group, F), lg.reshape(n_g, max_group),
            mg.reshape(n_g, max_group))
