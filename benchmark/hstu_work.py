"""The HSTU cell's work: the model's FLOPs over the valid tokens and the
query-key pairs the mask leaves open, kernel K6's FLOPs and bytes, and
the card's dense bfloat16 peak (NVIDIA's H100 SXM5 data sheet: 989
TFLOP/s dense BF16 on the tensor cores, at the 700 W limit).

Per block, over T valid tokens and P open pairs: the W1 projection
2 T d (2 H dv + 2 H dqk), the W2 projection 2 T H dv d, and the attention
products 2 P H (dqk + dv); once, over the Nc candidates: the feature
projection 2 Nc F d and the task heads 2 Nc d n_tasks. LayerNorm, SiLU
and the gathers are left out (elementwise work, no products).
"""
from __future__ import annotations

from benchmark import peaks

BF16_DENSE_FLOPS = 989e12
HBM_BYTES_PER_S = peaks.HBM_BYTES_PER_S


def model_flops(tokens, pairs, cands, h: dict, n_features: int, n_tasks: int) -> float:
    """The HSTU ranker's product FLOPs; `h` is the configuration's "hstu"."""
    d, H, dqk, dv = h["d_model"], h["n_heads"], h["d_qk"], h["d_v"]
    block = (2 * tokens * d * (2 * H * dv + 2 * H * dqk) + 2 * tokens * H * dv * d
             + k6_flops(pairs, H, dqk, dv))
    return float(h["n_blocks"] * block + 2 * cands * n_features * d + 2 * cands * d * n_tasks)


def k6_flops(pairs, H: int, dqk: int, dv: int):
    """Q.K and A.V over the open pairs, every head."""
    return 2 * pairs * H * (dqk + dv)


def k6_bytes(N: int, S: int, H: int, dqk: int, dv: int, n_pos: int, n_bkt: int) -> int:
    """One K6 call over N tokens of S sessions: Q, K (bf16, dqk wide) and V
    (bf16, dv wide) read once, the token timestamps, the offsets, history
    lengths and query-tile offsets (int32), the position biases (float32),
    the time biases and their bucket thresholds (float32 and int64), and Y
    (float32, dv wide) written once."""
    return (2 * N * H * (2 * dqk + dv) + 4 * N + 4 * (2 * (S + 1) + S) + 4 * n_pos
            + 12 * n_bkt + 4 * N * H * dv)
