"""hstu_attn_roofline: kernel K6's (ops/kernels/hstu_attention.py) share of
its roofline in the traced slice: the least time its calls need, the
larger of their FLOPs at the card's dense bfloat16 peak and their bytes at
HBM3's 3.35 TB/s (benchmark/hstu_work.py; each call's jagged shape and
open pairs recorded as it was made), over the time its kernels took on the
card. A program without K6 reads nothing."""

from benchmark import hstu_work

LAYER = "kernels"
UNIT = "%"
MOVES = {"serve": "sessions_per_s"}


def read(summary):
    if not summary.get("k6_s") or not summary.get("k6_calls"):
        return None
    least = max(summary["k6_flops"] / hstu_work.BF16_DENSE_FLOPS,
                summary["k6_bytes"] / hstu_work.HBM_BYTES_PER_S)
    return 100.0 * least / summary["k6_s"]
