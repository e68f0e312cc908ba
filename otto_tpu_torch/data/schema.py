"""Event and label tables on the host.

Counterpart of otto_tpu/data/schema.py: structure-of-arrays numpy tables
in the OTTO layout `[session i32, aid i32, ts i32 (seconds), type i8]`,
with parquet files of that layout as the exchange format. pyarrow is
imported only by the parquet methods: nothing else of the port needs it.
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

    @property
    def n_sessions(self) -> int:
        """Distinct session ids."""
        return len(np.unique(self.session))

    @property
    def n_aids(self) -> int:
        """One past the largest aid (0 for an empty table)."""
        return int(self.aid.max()) + 1 if len(self.aid) else 0

    def select(self, rows: np.ndarray) -> "Events":
        """The rows picked by a boolean mask or an index array."""
        return Events(self.session[rows], self.aid[rows], self.ts[rows],
                      self.type[rows])

    def sort_by_session_ts(self) -> "Events":
        return self.select(np.lexsort((self.ts, self.session)))

    def concat(self, other: "Events") -> "Events":
        """This table's rows, then `other`'s."""
        return Events(*(np.concatenate([getattr(self, c), getattr(other, c)])
                        for c in ("session", "aid", "ts", "type")))

    def to_parquet(self, path: str) -> None:
        _write_parquet(path, {"session": (self.session, "int32"), "aid": (self.aid, "int32"),
                              "ts": (self.ts, "int32"), "type": (self.type, "int8")})

    @staticmethod
    def from_parquet(path: str) -> "Events":
        t = _read_parquet(path)
        return Events(t["session"], t["aid"], t["ts"], t["type"])


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

    def to_parquet(self, path: str) -> None:
        _write_parquet(path, {"session": (self.session, "int32"), "type": (self.type, "int8"),
                              "aid": (self.aid, "int32")})

    @staticmethod
    def from_parquet(path: str) -> "Labels":
        t = _read_parquet(path)
        return Labels(t["session"], t["type"], t["aid"])


def _write_parquet(path: str, columns) -> None:
    """columns: name -> (array, arrow type name), in file order."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    pq.write_table(pa.table({name: pa.array(a, getattr(pa, typ)())
                             for name, (a, typ) in columns.items()}), path)


def _read_parquet(path: str):
    import pyarrow.parquet as pq

    t = pq.read_table(path)
    return {name: t[name].to_numpy() for name in t.column_names}
