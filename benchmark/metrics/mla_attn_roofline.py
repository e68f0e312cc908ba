"""mla_attn_roofline: the softmax form of kernel K6
(ops/kernels/softmax_attention.py, `softmax_attention_kernel`) and its share
of its roofline in the traced slice: the least time its calls need, the
larger of the open pairs' FLOPs at the card's dense bfloat16 peak and the
bytes (q, k, v read and y written once) at HBM3's 3.35 TB/s
(benchmark/mla_moe_work.py), over the time its kernels took on the card.
A program without it reads nothing."""

from benchmark import mla_moe_work

LAYER = "kernels"
UNIT = "%"
MOVES = {"serve": "sessions_per_s"}


def read(summary):
    if not summary.get("k6s_s") or not summary.get("k6s_calls"):
        return None
    least = max(summary["k6s_flops"] / mla_moe_work.BF16_DENSE_FLOPS,
                summary["k6s_bytes"] / mla_moe_work.HBM_BYTES_PER_S)
    return 100.0 * least / summary["k6s_s"]
