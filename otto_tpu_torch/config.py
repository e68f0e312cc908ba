"""Configuration of the serving path.

Counterpart of the part of otto_tpu/config.py that the ported modules
read: the event types and recall weights, the retrieval caps, the
co-visitation top-N per table and the shape of a GBDT ranker's trees.
Names and defaults are otto_tpu's; tests/test_torch_host.py holds them
equal. The settings of the offline stages (counting, embeddings,
clustering, training) come with those stages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

TYPES: Tuple[str, ...] = ("clicks", "carts", "orders")
TYPE2ID: Dict[str, int] = {t: i for i, t in enumerate(TYPES)}
# weighted recall@20 (the OTTO metric)
TYPE_WEIGHTS: Dict[str, float] = {"clicks": 0.1, "carts": 0.3, "orders": 0.6}

# co-visitation neighbours read per session aid at retrieval time, by
# table, in the tables' order (otto_tpu's CoVisConfig.retrieval_first_n)
COVIS_FIRST_N: Dict[str, int] = {
    "click_to_click": 10,
    "click_to_cart_or_buy": 10,
    "cart_to_cart": 20,
    "cart_to_buy": 20,
    "buy_to_buy": 20,
}


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    """Candidate retrieval caps."""

    # recency-adaptive trim: the aid at recency order r keeps its top
    # max(trim_min, trim_max_at_order_1 - slope * (r - 1)) ranked pairs
    trim_max_at_order_1: int = 20
    trim_min: int = 3
    trim_min_at_order: int = 20
    max_session_aids: int = 32      # kept unique aids per session
    max_candidates: int = 512       # padded candidate set per session
    session_len_buckets: Tuple[int, ...] = (8, 32, 128, 512)


@dataclasses.dataclass(frozen=True)
class GBDTConfig:
    """The shape of a GBDT ranker: what scoring needs of its config. A
    saved ranker's training settings are not read."""

    n_trees: int = 150
    max_depth: int = 4
    n_bins: int = 64

    @staticmethod
    def from_dict(d: dict) -> "GBDTConfig":
        """From a saved ranker's full config dict (extra keys ignored)."""
        return GBDTConfig(**{f.name: int(d[f.name])
                             for f in dataclasses.fields(GBDTConfig)})
