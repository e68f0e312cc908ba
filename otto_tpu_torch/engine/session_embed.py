"""Item kNN tables (counterpart of otto_tpu/engine/session_embed.py).

Only the table container is ported so far; `otto_tpu_torch.convert`
carries otto_tpu's tables across.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class KnnTables(NamedTuple):
    """Dense per-aid w2vec neighbour tables: neighbor [A, k] int32 (-1 pad)
    and dist [A, k] float32 squared L2."""

    neighbor: torch.Tensor
    dist: torch.Tensor
