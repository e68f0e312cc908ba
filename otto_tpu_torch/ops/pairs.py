"""Windowed co-event pair emission over padded session tensors.

Counterpart of otto_tpu/ops/pairs.py. A session's co-visitation pairs are
a dense masked [S, L, L] grid: cell (s, i, j) pairs event i ("this") with
event j ("next") of row s. The grid is elementwise torch on the rows'
device, flattened into (aid, aid_next) key streams for the counting
ladder (ops/counts.py).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch


class CountTypePlan(NamedTuple):
    """One count type: pairs from `type_this` events to `types_next`
    events at most `max_abs_dt` seconds apart."""

    name: str
    type_this: int
    types_next: Tuple[int, ...]
    max_abs_dt: int


class CoVisPlan(NamedTuple):
    """Every count type and the pair window min <= dt <= max."""

    types: Tuple[CountTypePlan, ...]
    min_time_to_next: int
    max_time_to_next: int


def make_plan(cfg) -> CoVisPlan:
    """The plan of a CoVisConfig."""
    return CoVisPlan(
        types=tuple(
            CountTypePlan(
                name=name,
                type_this=cfg.count_types[name][0],
                types_next=tuple(cfg.count_types[name][1]),
                max_abs_dt=cfg.max_time_to_next_by_type[name],
            )
            for name in cfg.names
        ),
        min_time_to_next=cfg.min_time_to_next,
        max_time_to_next=cfg.max_time_to_next,
    )


def _grid(aid, ts, plan: CoVisPlan, sess=None):
    """(this-aid [S, L, 1], next-aid [S, 1, L], dt [S, L, L], base mask):
    both events valid, not the same event, min <= dt <= max, and (with
    `sess`) the same session."""
    L = aid.shape[1]
    valid = aid >= 0
    dt = ts[:, None, :] - ts[:, :, None]
    not_self = ~torch.eye(L, dtype=torch.bool, device=aid.device)[None]
    base = (
        valid[:, :, None]
        & valid[:, None, :]
        & not_self
        & (dt >= plan.min_time_to_next)
        & (dt <= plan.max_time_to_next)
    )
    if sess is not None:
        base = base & (sess[:, :, None] == sess[:, None, :])
    return aid[:, :, None], aid[:, None, :], dt, base


def _next_ok(t_j: torch.Tensor, tp: CountTypePlan) -> torch.Tensor:
    ok = torch.zeros_like(t_j, dtype=torch.bool)
    for tn in tp.types_next:
        ok = ok | (t_j == tn)
    return ok


def emit_pairs(
    aid: torch.Tensor,      # [S, L] int32, -1 padding
    ts: torch.Tensor,       # [S, L] int32
    type_: torch.Tensor,    # [S, L] int32
    plan: CoVisPlan,
) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Per count type, the flat (aid, aid_next, valid) pair streams: pair
    (i -> j) counts when the base mask holds, type[i] == type_this,
    type[j] in types_next and |dt| <= the type's cap."""
    S, L = aid.shape
    a_i, a_j, dt, base = _grid(aid, ts, plan)
    t_i = type_[:, :, None]
    t_j = type_[:, None, :]
    flat_a = a_i.expand(S, L, L).reshape(-1)
    flat_b = a_j.expand(S, L, L).reshape(-1)
    out = []
    for tp in plan.types:
        m = base & (t_i == tp.type_this) & _next_ok(t_j, tp) & (dt.abs() <= tp.max_abs_dt)
        out.append((flat_a, flat_b, m.reshape(-1)))
    return out


def pair_budget_sessions(L: int, budget_pairs: int = 1 << 22) -> int:
    """How many rows of padded length L fit a per-batch pair budget."""
    return max(1, budget_pairs // (L * L))


# Tag multiplier packing the count-type index into the aid key:
# k1 = type_idx * AID_STRIDE + aid. 2^23 > the 1.8M OTTO aids; 5 types *
# stride stays far inside int32.
AID_STRIDE = 1 << 23


def plan_types_disjoint(plan: CoVisPlan) -> bool:
    """True when no (type_this, type_next) combination belongs to two count
    types: the condition for one type-tagged stream."""
    seen = set()
    for tp in plan.types:
        for tn in tp.types_next:
            if (tp.type_this, tn) in seen:
                return False
            seen.add((tp.type_this, tn))
    return True


def emit_pairs_tagged(
    aid: torch.Tensor,      # [S, L] int32, -1 padding
    ts: torch.Tensor,       # [S, L] int32
    type_: torch.Tensor,    # [S, L] int32
    plan: CoVisPlan,
    pad_to: int = 0,
    sess: Optional[torch.Tensor] = None,  # [S, L] int32 lane session id
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One type-tagged flat pair stream (k1, k2, valid) with k1 =
    type_idx * AID_STRIDE + aid_this: emit_pairs' pairs, the types being
    disjoint (plan_types_disjoint). pad_to > S * L * L pads the stream with
    invalid lanes to that length; `sess` masks cross-session cells of
    shelf-packed rows."""
    S, L = aid.shape
    a_i, a_j, dt, base = _grid(aid, ts, plan, sess)
    t_i = type_[:, :, None]
    t_j = type_[:, None, :]
    adt = dt.abs()
    tag = torch.zeros((S, L, L), dtype=torch.int32, device=aid.device)
    any_m = torch.zeros((S, L, L), dtype=torch.bool, device=aid.device)
    for idx, tp in enumerate(plan.types):
        m = (t_i == tp.type_this) & _next_ok(t_j, tp) & (adt <= tp.max_abs_dt)
        tag = torch.where(m, idx, tag)
        any_m = any_m | m
    m = (base & any_m).reshape(-1)
    k1 = (tag * AID_STRIDE + a_i).reshape(-1)
    k2 = a_j.expand(S, L, L).reshape(-1)
    pad = pad_to - S * L * L
    if pad > 0:
        k1, k2, m = (torch.cat([x, x.new_zeros(pad)]) for x in (k1, k2, m))
    return k1, k2, m
