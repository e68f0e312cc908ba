"""Synthetic OTTO-like sessions, generated on a device.

Counterpart of otto_tpu/data/synthetic.py: the same schema, knobs and
latent structure (zipf item popularity, latent item categories with
within-category steps, revisits of earlier session items, a click ->
cart -> order funnel), drawn with a `torch.Generator` on the given
device. The random stream is torch's, so the events differ from
otto_tpu's `generate` draw for draw.

The session walk is a loop over the L time steps with all S sessions as
one vector; the padded [S, L] grids are flattened to the ragged event
table on the device, and only the flat columns reach the host.
"""
from __future__ import annotations

import dataclasses
import math

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


def generate(spec: SyntheticSpec, device) -> Events:
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
