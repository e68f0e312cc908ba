"""JSONL ingestion (C6) of the port against otto_tpu's loader, mirroring
test_jsonl.py: the native parser (native/jsonl_pack.cc, built by the port
at first use) and the Python parser give otto_tpu's arrays, exactly."""
import json
import logging
import time

import numpy as np
import pytest

from otto_tpu.data import jsonl as ref_jsonl
from otto_tpu_torch.data import jsonl
from otto_tpu_torch.ops.kernels import _build


@pytest.fixture()
def sessions_file(tmp_path):
    rows = [
        {"session": 1, "events": [
            {"aid": 10, "ts": 1661724000000, "type": "clicks"},
            {"aid": 11, "ts": 1661724060000, "type": "carts"},
        ]},
        {"session": 2, "events": [{"aid": 12, "ts": 1661724120000, "type": "orders"}]},
        {"session": 7, "events": [{"aid": 3, "ts": 1200, "type": "clicks"}]},
    ]
    p = tmp_path / "sessions.jsonl"
    p.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    return str(p)


@pytest.fixture()
def labels_file(tmp_path):
    rows = [
        {"session": 1, "labels": {"clicks": 99, "carts": [5, 6], "orders": []}},
        {"session": 2, "labels": {"orders": [7]}},
    ]
    p = tmp_path / "labels.jsonl"
    p.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return str(p)


def _columns(x, names):
    return [getattr(x, n) for n in names]


@pytest.mark.parametrize("native", [True, False])
def test_sessions_match_reference(sessions_file, native):
    assert jsonl.parser_kind(native) == ("native" if native else "python")
    got = jsonl.load_sessions_jsonl(sessions_file, native=native)
    want = ref_jsonl.load_sessions_jsonl(sessions_file, native=False)
    for g, w in zip(_columns(got, ("session", "aid", "ts", "type")),
                    _columns(want, ("session", "aid", "ts", "type"))):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert got.ts.tolist() == [1661724000, 1661724060, 1661724120, 1200]   # ms -> s
    assert got.type.tolist() == [0, 1, 2, 0]


@pytest.mark.parametrize("native", [True, False])
def test_labels_match_reference(labels_file, native):
    got = jsonl.load_labels_jsonl(labels_file, native=native)
    want = ref_jsonl.load_labels_jsonl(labels_file, native=False)

    def rows(la):
        return sorted(zip(la.session.tolist(), la.type.tolist(), la.aid.tolist()))
    assert rows(got) == rows(want) == [(1, 0, 99), (1, 1, 5), (1, 1, 6), (2, 2, 7)]


def test_native_parses_large_file_fast(tmp_path):
    """50k events: the native parser well under a second, equal to
    otto_tpu's Python parser."""
    rng = np.random.default_rng(0)
    lines = []
    for s in range(5000):
        events = [{"aid": int(rng.integers(0, 10000)), "ts": 1661724000000 + i * 1000,
                   "type": ["clicks", "carts", "orders"][int(rng.integers(0, 3))]}
                  for i in range(10)]
        lines.append(json.dumps({"session": s, "events": events}))
    p = tmp_path / "big.jsonl"
    p.write_text("\n".join(lines))
    jsonl.load_sessions_jsonl(str(p))   # the first call may build the parser
    t = time.perf_counter()
    ev = jsonl.load_sessions_jsonl(str(p))
    dt = time.perf_counter() - t
    assert jsonl.parser_kind() == "native" and len(ev) == 50_000 and dt < 1.0, dt
    want = ref_jsonl.load_sessions_jsonl(str(p), native=False)
    np.testing.assert_array_equal(ev.aid, want.aid)
    np.testing.assert_array_equal(ev.ts, want.ts)


@pytest.mark.parametrize("native", [True, False])
def test_missing_file_raises(native):
    with pytest.raises(FileNotFoundError):
        jsonl.load_sessions_jsonl("/nonexistent.jsonl", native=native)


def test_python_parser_without_a_compiler(sessions_file, monkeypatch, caplog):
    """No host compiler: the loaders fall back to the Python parser, with
    the same events, and say so."""
    def no_compiler(src):
        raise RuntimeError("no host C++ compiler")

    jsonl._native_lib.cache_clear()
    monkeypatch.setattr(_build, "build_host", no_compiler)
    try:
        with caplog.at_level(logging.INFO, logger=jsonl.log.name):
            got = jsonl.load_sessions_jsonl(sessions_file)
        assert jsonl.parser_kind() == "python"
        assert "with the python parser" in caplog.text
    finally:
        jsonl._native_lib.cache_clear()
    want = ref_jsonl.load_sessions_jsonl(sessions_file, native=False)
    np.testing.assert_array_equal(got.session, want.session)
    np.testing.assert_array_equal(got.ts, want.ts)
