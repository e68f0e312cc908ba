"""Co-visitation retrieval tables (counterpart of otto_tpu/engine/covis.py).

Only the table container is ported so far: the counting stages that build
it still run in otto_tpu, and `otto_tpu_torch.convert` carries their
output across.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CoVisTables(NamedTuple):
    """Dense per-aid top-N tables for one count type, each [A, N] int32:
    neighbor (top-N aid_next by count desc, -1 pad), count (raw pair
    count), count_pop ((count - min) / (q9999 - min) clipped, x10_000),
    perc_pop (global rank / total pairs x10_000) and count_rel (count /
    max count over the aid x100). The per-aid rank is column index + 1."""

    neighbor: torch.Tensor
    count: torch.Tensor
    count_pop: torch.Tensor
    perc_pop: torch.Tensor
    count_rel: torch.Tensor
