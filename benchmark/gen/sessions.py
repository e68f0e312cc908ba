"""Test sessions of the serving cells, drawn on the card from the seed.

`generate_device` is a frozen copy of
`otto_tpu_torch/data/synthetic.py::generate_device` at commit 7f160d3 (the
port's synthetic generator: zipf item popularity, latent item categories
with within-category steps, revisits, a click -> cart -> order funnel),
returning the flat columns and, besides, the latent-category permutation
that the table generator (gen/tables.py) draws neighbour lists from; one
addition, `lengths`, replaces the session lengths it draws (the draw is
still made, so every later draw is the same). With `lengths=None`,
benchmark/tests/test_bench_frozen.py holds its events equal to the port's.

`session_stream` draws the session lengths and each session's cut (a
uniform index in [1, len - 1], as `data/split.py` cuts the test week, so
the stream has the test week's length mix) from `shape_seed`, and the
sessions' contents from the spec's seed: every run seed serves the same
sizes in the same order, and only what the sessions hold changes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

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


class Generated(NamedTuple):
    """(session, ts)-sorted int32 event columns (type int8) and the
    latent-category permutation perm (aid -> slot) on the device."""

    session: np.ndarray
    aid: np.ndarray
    ts: np.ndarray
    type: np.ndarray
    perm: torch.Tensor


def generate_device(spec: SyntheticSpec, device,
                    lengths: Optional[torch.Tensor] = None) -> Generated:
    """(session, ts)-sorted events of `spec.n_sessions` sessions, drawn on
    `device`; session ids are 0..n_sessions-1, item ids are popularity
    ranks. `lengths` [n_sessions] int64, if given, replaces the drawn
    lengths."""
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
    drawn = torch.empty(S, dtype=torch.float64, device=dev).log_normal_(
        math.log(spec.mean_len), 0.7, generator=g).to(i64).clamp(2, L)
    lengths = drawn if lengths is None else lengths.to(dev)

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
    cols = [x[valid].to(torch.int32).cpu().numpy() for x in (session, aid, ts, typ)]
    return Generated(cols[0], cols[1], cols[2], cols[3].astype(np.int8), perm)


class SessionStream(NamedTuple):
    """The visible prefixes of the test sessions, (session, ts)-sorted:
    event columns and each session's first event (`starts`, [n + 1])."""

    session: np.ndarray
    aid: np.ndarray
    ts: np.ndarray
    type: np.ndarray
    starts: np.ndarray
    perm: torch.Tensor

    @property
    def n_sessions(self) -> int:
        return len(self.starts) - 1

    def lengths(self) -> np.ndarray:
        return np.diff(self.starts)


def session_stream(spec: SyntheticSpec, shape_seed: int, device) -> SessionStream:
    """generate_device's sessions at lengths drawn as it draws them, then
    each cut at 1 + floor(u * (len - 1)) events with u uniform, both from
    a torch.Generator seeded with shape_seed on `device`: every session
    keeps at least one event and loses at least one."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(shape_seed)
    full = torch.empty(spec.n_sessions, dtype=torch.float64, device=dev).log_normal_(
        math.log(spec.mean_len), 0.7, generator=g).to(torch.int64).clamp(2, spec.max_len)
    gen = generate_device(spec, device, lengths=full)
    n = spec.n_sessions
    lens = np.bincount(gen.session, minlength=n)
    u = torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    cut = (1 + (u.cpu().numpy() * (lens - 1)).astype(np.int64))
    starts = np.concatenate([[0], np.cumsum(lens)])
    pos = np.arange(len(gen.session)) - np.repeat(starts[:-1], lens)
    keep = pos < np.repeat(cut, lens)
    vstarts = np.concatenate([[0], np.cumsum(cut)])
    return SessionStream(gen.session[keep], gen.aid[keep], gen.ts[keep], gen.type[keep],
                         vstarts, gen.perm)
