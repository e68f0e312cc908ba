"""The MLA + MoE cell's work: the model's product FLOPs over the valid tokens
and the query-key pairs the mask leaves open, kernel K9's and K6's softmax
form's FLOPs and bytes, and the card's dense bfloat16 peak (NVIDIA's H100
SXM5 data sheet: 989 TFLOP/s dense BF16 on the tensor cores, at 700 W).

`m` is the configuration's model keys (MLAMoEConfig's names). Per token
and layer: q (2 d H (nope + rope)), the latent and k_pe (2 d (r + rope)),
k_nope and v (2 r H (nope + dv)), the output projection (2 H dv d); a
dense layer's MLP 6 d I; a MoE layer's router 2 d E and its (k + n_shared)
experts' 6 d Ie each; per open pair and head, q.k and a.v (2 (nope + rope
+ dv)); once per candidate, the feature projection 2 F d and the heads
2 d n_tasks. RMSNorm, RoPE, softmax, SiLU, sorting and the gathers are
left out (no products).
"""
from __future__ import annotations

from benchmark import peaks

BF16_DENSE_FLOPS = 989e12
HBM_BYTES_PER_S = peaks.HBM_BYTES_PER_S


def token_layer_flops(m: dict, dense: bool) -> int:
    """One token's product FLOPs in one layer, attention pairs aside."""
    d, H = m["hidden_size"], m["num_attention_heads"]
    qk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    r, dv = m["kv_lora_rank"], m["v_head_dim"]
    attn = (2 * d * H * qk + 2 * d * (r + m["qk_rope_head_dim"])
            + 2 * r * H * (m["qk_nope_head_dim"] + dv) + 2 * H * dv * d)
    if dense:
        return attn + 6 * d * m["intermediate_size"]
    experts = m["num_experts_per_tok"] + m["n_shared_experts"]
    return attn + 2 * d * m["n_routed_experts"] + experts * 6 * d * m["moe_intermediate_size"]


def model_flops(tokens, pairs, cands, m: dict, n_features: int, n_tasks: int) -> float:
    """The ranker's product FLOPs over `tokens` valid tokens, `pairs` open
    query-key pairs (a candidate's own key included) and `cands` candidates."""
    n_dense = m["first_k_dense_replace"]
    n_moe = m["num_hidden_layers"] - n_dense
    per_token = (n_dense * token_layer_flops(m, True) + n_moe * token_layer_flops(m, False))
    per_pair = m["num_hidden_layers"] * softmax_flops(
        1, m["num_attention_heads"], m["qk_nope_head_dim"] + m["qk_rope_head_dim"],
        m["v_head_dim"])
    d = m["hidden_size"]
    return float(tokens * per_token + pairs * per_pair
                 + cands * (2 * n_features * d + 2 * d * n_tasks))


def k9_flops(R: int, N_w: int, K: int) -> int:
    """One K9 call: R sorted rows by their expert's [N_w, K] weights."""
    return 2 * R * N_w * K


def k9_bytes(R: int, E: int, N_w: int, K: int, gate_up: bool) -> int:
    """One K9 call over R rows and E experts: the rows read once (bf16,
    K wide), every expert's weights read once (bf16), the offsets (int32,
    twice: segments and tiles), the row index (gate_up) or the destination
    rows and weights (int32, float32), and the output written once (bf16
    N_w / 2 wide with gate_up, float32 N_w wide without)."""
    out = R * (N_w // 2) * 2 if gate_up else R * N_w * 4
    index = 4 * R if gate_up else 8 * R
    return 2 * R * K + 2 * E * N_w * K + 8 * (E + 1) + index + out


def softmax_flops(pairs, H: int, dqk: int, dv: int):
    """q.k and a.v over the open pairs, every head."""
    return 2 * pairs * H * (dqk + dv)


def softmax_bytes(N: int, S: int, H: int, dqk: int, dv: int) -> int:
    """One call of K6's softmax form over N tokens of S sessions: q and k
    (bf16, dqk wide) and v (bf16, dv wide) read once, the offsets, history
    lengths and query-tile offsets (int32), and y (float32, dv wide)
    written once."""
    return 2 * N * H * (2 * dqk + dv) + 4 * (2 * (S + 1) + S) + 4 * N * H * dv
