"""Synthetic OTTO-like sessions.

Counterpart of otto_tpu/data/synthetic.py: the same schema, knobs and
latent structure (zipf item popularity, latent item categories with
within-category steps, revisits of earlier session items, a click ->
cart -> order funnel), by two generators:

- `generate`: otto_tpu's numpy generator, draw for draw (numpy's PCG64
  stream), so a synthetic run of the port sees otto_tpu's events;
- `generate_device`: the same walk drawn with a `torch.Generator` on a
  device. Its random stream is torch's, so its events differ from
  `generate`'s draw for draw. The session walk is a loop over the L time
  steps with all S sessions as one vector; the padded [S, L] grids are
  flattened to the ragged event table on the device, and only the flat
  columns reach the host.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from otto_tpu_torch.data.schema import Events

DAY = 24 * 60 * 60


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    n_sessions: int = 10_000
    n_aids: int = 20_000
    max_len: int = 64
    mean_len: float = 15.0
    cat_size: int = 50           # latent category size
    zipf_a: float = 1.2          # popularity skew
    p_revisit: float = 0.25      # next event revisits an earlier session item
    p_neighbor: float = 0.45     # next event stays within the latent category
    p_cart: float = 0.10         # a click upgrades to a cart
    p_order_after_cart: float = 0.25  # a carted item later produces an order
    span_days: int = 28          # dataset time span
    seed: int = 0


def _zipf_draw(rng: np.random.Generator, spec: SyntheticSpec, size) -> np.ndarray:
    """Item ids with zipf popularity; id == popularity rank."""
    u = rng.random(size)
    # inverse CDF of a truncated zipf by a power transform
    ranks = (spec.n_aids ** (u ** spec.zipf_a)).astype(np.int64) - 1
    return np.clip(ranks, 0, spec.n_aids - 1).astype(np.int32)


def generate(spec: SyntheticSpec) -> Events:
    """(session, ts)-sorted events of `spec.n_sessions` sessions from
    numpy's generator seeded with spec.seed, bit-equal to otto_tpu's
    `generate`; session ids are 0..n_sessions-1, item ids popularity
    ranks."""
    rng = np.random.default_rng(spec.seed)
    S, L = spec.n_sessions, spec.max_len
    # latent categories: a fixed permutation of the item space
    perm = rng.permutation(spec.n_aids).astype(np.int32)
    perm_inv = np.argsort(perm).astype(np.int32)
    lengths = np.clip(rng.lognormal(np.log(spec.mean_len), 0.7, S).astype(np.int32), 2, L)

    aid = np.zeros((S, L), np.int32)
    typ = np.zeros((S, L), np.int8)
    carted = np.full((S, 4), -1, np.int32)   # ring buffer of carted aids
    n_carted = np.zeros(S, np.int32)
    rows = np.arange(S)
    aid[:, 0] = _zipf_draw(rng, spec, S)
    for t in range(1, L):
        u = rng.random(S)
        slot = perm[aid[:, t - 1]] // spec.cat_size * spec.cat_size + rng.integers(
            0, spec.cat_size, S)
        nbr = perm_inv[np.clip(slot, 0, spec.n_aids - 1)]
        prev = aid[rows, rng.integers(0, t, S)]
        fresh = _zipf_draw(rng, spec, S)
        aid[:, t] = np.where(u < spec.p_revisit, prev,
                             np.where(u < spec.p_revisit + spec.p_neighbor, nbr, fresh))
        is_cart = rng.random(S) < spec.p_cart
        is_order = (rng.random(S) < spec.p_order_after_cart) & (n_carted > 0) & ~is_cart
        typ[:, t] = np.where(is_cart, 1, np.where(is_order, 2, 0)).astype(np.int8)
        # an order re-targets a previously carted item
        pick = rng.integers(0, 4, S) % np.maximum(n_carted, 1)
        aid[:, t] = np.where(is_order, carted[rows, pick], aid[:, t])
        ring_pos = n_carted % 4
        carted[is_cart, ring_pos[is_cart]] = aid[is_cart, t]
        n_carted = n_carted + is_cart.astype(np.int32)

    # session start uniform over the span, exponential gaps (median ~1 min)
    start = rng.integers(0, spec.span_days * DAY, S)[:, None]
    gaps = rng.exponential(90.0, (S, L)).astype(np.int64) + 1
    ts = (start + np.cumsum(gaps, axis=1)).astype(np.int32)
    mask = np.arange(L)[None, :] < lengths[:, None]
    session = np.broadcast_to(np.arange(S, dtype=np.int32)[:, None], (S, L))
    return Events(session[mask], aid[mask], ts[mask], typ[mask]).sort_by_session_ts()


def generate_device(spec: SyntheticSpec, device) -> Events:
    """(session, ts)-sorted events of `spec.n_sessions` sessions, drawn on
    `device` (named by the caller: there is no default); session ids are
    0..n_sessions-1, item ids are popularity ranks."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(spec.seed)
    S, L, A = spec.n_sessions, spec.max_len, spec.n_aids
    i64 = torch.int64

    def uniform(*shape):
        return torch.rand(shape, generator=g, device=dev, dtype=torch.float64)

    def randint(hi, *shape):
        return torch.randint(0, hi, shape, generator=g, device=dev)

    def zipf(n):
        # inverse CDF of a truncated zipf by a power transform
        return ((A ** (uniform(n) ** spec.zipf_a)).to(i64) - 1).clamp(0, A - 1)

    perm = torch.randperm(A, generator=g, device=dev)       # aid -> slot
    perm_inv = torch.argsort(perm)                          # slot -> aid
    lengths = torch.empty(S, dtype=torch.float64, device=dev).log_normal_(
        math.log(spec.mean_len), 0.7, generator=g).to(i64).clamp(2, L)

    aid = torch.zeros((S, L), dtype=i64, device=dev)
    typ = torch.zeros((S, L), dtype=torch.int8, device=dev)
    carted = torch.full((S, 4), -1, dtype=i64, device=dev)  # ring buffer
    n_carted = torch.zeros(S, dtype=i64, device=dev)
    rows = torch.arange(S, device=dev)
    aid[:, 0] = zipf(S)
    for t in range(1, L):
        u = uniform(S)
        slot = perm[aid[:, t - 1]] // spec.cat_size * spec.cat_size + randint(spec.cat_size, S)
        nbr = perm_inv[slot.clamp(max=A - 1)]
        prev = aid[rows, randint(t, S)]
        nxt = torch.where(u < spec.p_revisit, prev,
                          torch.where(u < spec.p_revisit + spec.p_neighbor, nbr, zipf(S)))
        is_cart = uniform(S) < spec.p_cart
        is_order = (uniform(S) < spec.p_order_after_cart) & (n_carted > 0) & ~is_cart
        # an order re-targets a previously carted item
        pick = randint(4, S) % n_carted.clamp(min=1)
        nxt = torch.where(is_order, carted[rows, pick], nxt)
        aid[:, t] = nxt
        typ[:, t] = torch.where(is_cart, 1, torch.where(is_order, 2, 0)).to(torch.int8)
        push = is_cart[:, None] & (torch.arange(4, device=dev) == (n_carted % 4)[:, None])
        carted = torch.where(push, nxt[:, None], carted)
        n_carted = n_carted + is_cart.to(i64)

    # session start uniform over the span, exponential gaps (median ~1 min)
    start = randint(spec.span_days * DAY, S, 1)
    gaps = torch.empty((S, L), dtype=torch.float64, device=dev).exponential_(
        1 / 90.0, generator=g).to(i64) + 1
    ts = start + torch.cumsum(gaps, dim=1)
    valid = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    session = rows[:, None].expand(S, L)
    return Events(*(x[valid].to(torch.int32).cpu().numpy()
                    for x in (session, aid, ts, typ)))
