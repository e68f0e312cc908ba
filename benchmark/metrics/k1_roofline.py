"""k1_roofline: kernel K1's (ops/kernels/gather.py) share of its roofline
in the traced slice: the least time its calls' bytes need at HBM3's
3.35 TB/s (benchmark/peaks.py::k1_bytes, each call's shape recorded as it
was made) over the time its kernels took on the card."""

from benchmark import peaks

LAYER = "kernels"
UNIT = "%"
MOVES = {"serve": "sessions_per_s", "nearline": "request_p90_ms"}


def read(summary):
    if not summary.get("k1_s") or not summary.get("k1_bytes"):
        return None
    return 100.0 * summary["k1_bytes"] / peaks.HBM_BYTES_PER_S / summary["k1_s"]
