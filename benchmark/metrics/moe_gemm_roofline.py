"""moe_gemm_roofline: kernel K9's (ops/kernels/grouped_gemm.py) share of its
roofline in the traced slice: the least time its calls need, the larger of
their FLOPs at the card's dense bfloat16 peak and their bytes at HBM3's
3.35 TB/s (benchmark/mla_moe_work.py; each call's rows, experts and widths
recorded as it was made), over the time its kernels took on the card. A
program without K9 reads nothing."""

from benchmark import mla_moe_work

LAYER = "kernels"
UNIT = "%"
MOVES = {"serve": "sessions_per_s"}


def read(summary):
    if not summary.get("k9_s") or not summary.get("k9_calls"):
        return None
    least = max(summary["k9_flops"] / mla_moe_work.BF16_DENSE_FLOPS,
                summary["k9_bytes"] / mla_moe_work.HBM_BYTES_PER_S)
    return 100.0 * least / summary["k9_s"]
