"""Cluster-popularity tables (counterpart of otto_tpu/engine/popularity.py).

Only the table container is ported so far; `otto_tpu_torch.convert`
carries otto_tpu's tables across.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class PopularityTables(NamedTuple):
    """candidate [C, T] int32: aids whose best rank <= keep_top_k, -1 pad;
    ranks [C, T, 6] int32: the six rank columns (clip 999) aligned with
    candidate; aid_rank [A, 6] int32: rank lookup for every aid, 999 when
    absent."""

    candidate: torch.Tensor
    ranks: torch.Tensor
    aid_rank: torch.Tensor
