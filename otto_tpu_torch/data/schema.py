"""Event and label tables on the host.

Counterpart of otto_tpu/data/schema.py: structure-of-arrays numpy tables
in the OTTO layout `[session i32, aid i32, ts i32 (seconds), type i8]`.
Parquet input and output stay with otto_tpu.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Events:
    """Flat event table."""

    session: np.ndarray  # int32 [E]
    aid: np.ndarray      # int32 [E]
    ts: np.ndarray       # int32 [E] seconds
    type: np.ndarray     # int8  [E] 0=clicks 1=carts 2=orders

    def __post_init__(self):
        self.session = np.asarray(self.session, np.int32)
        self.aid = np.asarray(self.aid, np.int32)
        self.ts = np.asarray(self.ts, np.int32)
        self.type = np.asarray(self.type, np.int8)

    def __len__(self) -> int:
        return len(self.session)

    def select(self, rows: np.ndarray) -> "Events":
        """The rows picked by a boolean mask or an index array."""
        return Events(self.session[rows], self.aid[rows], self.ts[rows],
                      self.type[rows])

    def sort_by_session_ts(self) -> "Events":
        return self.select(np.lexsort((self.ts, self.session)))


@dataclasses.dataclass
class Labels:
    """Ground truth `[session, type, aid]`."""

    session: np.ndarray  # int32 [N]
    type: np.ndarray     # int8  [N]
    aid: np.ndarray      # int32 [N]

    def __post_init__(self):
        self.session = np.asarray(self.session, np.int32)
        self.type = np.asarray(self.type, np.int8)
        self.aid = np.asarray(self.aid, np.int32)

    def __len__(self) -> int:
        return len(self.session)

    def for_type(self, type_id: int) -> "Labels":
        m = self.type == type_id
        return Labels(self.session[m], self.type[m], self.aid[m])
