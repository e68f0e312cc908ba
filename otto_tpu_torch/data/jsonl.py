"""OTTO JSONL ingestion (C6).

Counterpart of otto_tpu/data/jsonl.py. The native parser is
`native/jsonl_pack.cc`, compiled by the host compiler at first use into
`otto_tpu_torch/build/` (`ops/kernels/_build.py::build_host`, as the
co-visitation merge's `native/kmerge.cc` is); without a compiler the
Python parser runs, with the same output. Each load logs which parser
ran; `parser_kind()` says which one will.

Sessions: {"session": S, "events": [{"aid": A, "ts": T, "type": "clicks"}, ...]}
Labels:   {"session": S, "labels": {"clicks": A, "carts": [A, ...], "orders": [...]}}
Timestamps above 1e11 are milliseconds and become seconds.
"""
from __future__ import annotations

import ctypes
import functools
import json
import logging
from typing import Optional

import numpy as np

from otto_tpu_torch.config import TYPE2ID
from otto_tpu_torch.data.schema import Events, Labels
from otto_tpu_torch.ops.kernels import _build

log = logging.getLogger(__name__)

JSONL_SOURCE = _build.PKG_DIR.parent / "native" / "jsonl_pack.cc"


@functools.lru_cache(maxsize=None)
def _native_lib() -> Optional[ctypes.CDLL]:
    """The native parser, built on first use; None when the source or a
    host compiler is missing."""
    if not JSONL_SOURCE.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_build.build_host(JSONL_SOURCE)))
    except (RuntimeError, OSError) as err:
        log.warning("native JSONL parser unavailable, parsing in Python: %s", err)
        return None
    pi32 = ctypes.POINTER(ctypes.c_int32)
    pi8 = ctypes.POINTER(ctypes.c_int8)
    lib.parse_sessions_jsonl.restype = ctypes.c_int64
    lib.parse_sessions_jsonl.argtypes = [ctypes.c_char_p, ctypes.POINTER(pi32),
                                         ctypes.POINTER(pi32), ctypes.POINTER(pi32),
                                         ctypes.POINTER(pi8)]
    lib.parse_labels_jsonl.restype = ctypes.c_int64
    lib.parse_labels_jsonl.argtypes = [ctypes.c_char_p, ctypes.POINTER(pi32),
                                       ctypes.POINTER(pi8), ctypes.POINTER(pi32)]
    lib.otto_free.argtypes = [ctypes.c_void_p]
    return lib


def _take(lib, ptr, n: int, dtype) -> np.ndarray:
    """Copy n values out of a buffer the parser allocated, then free it."""
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True) if n else \
        np.zeros(0, dtype)
    lib.otto_free(ptr)
    return arr


def parser_kind(native: bool = True) -> str:
    """Which parser the loaders run: 'native' or 'python'."""
    return "native" if native and _native_lib() is not None else "python"


def _ran(parser: str, path: str, n: int, what: str) -> None:
    log.info("parsed %d %s from %s with the %s parser", n, what, path, parser)


def load_sessions_jsonl(path: str, native: bool = True) -> Events:
    """OTTO sessions JSONL -> Events, in file order."""
    lib = _native_lib() if native else None
    if lib is None:
        ev = _load_sessions_python(path)
        _ran("python", path, len(ev), "events")
        return ev
    pi32, pi8 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int8)
    s, a, t, ty = pi32(), pi32(), pi32(), pi8()
    n = lib.parse_sessions_jsonl(str(path).encode(), ctypes.byref(s), ctypes.byref(a),
                                 ctypes.byref(t), ctypes.byref(ty))
    if n < 0:
        raise FileNotFoundError(path)
    ev = Events(_take(lib, s, n, np.int32), _take(lib, a, n, np.int32),
                _take(lib, t, n, np.int32), _take(lib, ty, n, np.int8))
    _ran("native", path, n, "events")
    return ev


def load_labels_jsonl(path: str, native: bool = True) -> Labels:
    """OTTO labels JSONL -> Labels (a bare aid counts as a one-aid list)."""
    lib = _native_lib() if native else None
    if lib is None:
        lab = _load_labels_python(path)
        _ran("python", path, len(lab), "labels")
        return lab
    pi32, pi8 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int8)
    s, ty, a = pi32(), pi8(), pi32()
    n = lib.parse_labels_jsonl(str(path).encode(), ctypes.byref(s), ctypes.byref(ty),
                               ctypes.byref(a))
    if n < 0:
        raise FileNotFoundError(path)
    lab = Labels(_take(lib, s, n, np.int32), _take(lib, ty, n, np.int8),
                 _take(lib, a, n, np.int32))
    _ran("native", path, n, "labels")
    return lab


def _ts_seconds(ts: int) -> int:
    return ts // 1000 if ts > 100_000_000_000 else ts


def _load_sessions_python(path: str) -> Events:
    session, aid, ts, typ = [], [], [], []
    with open(path) as fh:
        for line in fh:
            if not line.strip():
                continue
            row = json.loads(line)
            for e in row["events"]:
                session.append(row["session"])
                aid.append(e["aid"])
                ts.append(_ts_seconds(e["ts"]))
                typ.append(TYPE2ID[e["type"]])
    return Events(np.asarray(session, np.int32), np.asarray(aid, np.int32),
                  np.asarray(ts, np.int32), np.asarray(typ, np.int8))


def _load_labels_python(path: str) -> Labels:
    session, typ, aid = [], [], []
    with open(path) as fh:
        for line in fh:
            if not line.strip():
                continue
            row = json.loads(line)
            for tname, aids in row["labels"].items():
                for a in aids if isinstance(aids, list) else [aids]:
                    session.append(row["session"])
                    typ.append(TYPE2ID[tname])
                    aid.append(a)
    return Labels(np.asarray(session, np.int32), np.asarray(typ, np.int8),
                  np.asarray(aid, np.int32))

