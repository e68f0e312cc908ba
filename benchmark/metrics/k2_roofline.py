"""k2_roofline: kernel K2's (ops/kernels/segscan.py) share of its roofline
in the traced slice: the least time its calls' bytes need at HBM3's
3.35 TB/s (benchmark/peaks.py::k2_bytes) over the time its kernels took
on the card."""

from benchmark import peaks

LAYER = "kernels"
UNIT = "%"
MOVES = {"serve": "sessions_per_s", "nearline": "request_p90_ms"}


def read(summary):
    if not summary.get("k2_s") or not summary.get("k2_bytes"):
        return None
    return 100.0 * summary["k2_bytes"] / peaks.HBM_BYTES_PER_S / summary["k2_s"]
