"""A DeepSeek-V3-style decoder (latent attention, sparse experts) as a
multi-task ranker (`ranker_backend="mla_moe"`).

The role is that of HLLM's user model (Chen et al., arXiv:2409.12740):
item embeddings are the input tokens of a decoder that reads the user's
history, and in the early-fusion form the candidates are appended as
tokens and each candidate's last hidden state is scored. The widths are
a public MoE's (MLAMoEConfig's defaults: Moonlight-16B-A3B). One pass
scores every candidate of a batch for the three target types: each
candidate attends the whole history and itself only (the target-aware
mask of the HSTU ranker, models/hstu.py, whose `pack` lays the tokens out).

Tokens. History event i of the last max_seq_len events: `E[aid] +
T[type]`, at RoPE position i. Candidate c: `E[cand] + P f_c` at position
L (the kept history's length), f_c its retrieval features, log-squashed
and normalised as the HSTU ranker's are. E [A, d] is the bfloat16 item
table, read through kernel K4 as int32 words.

Each layer, on X [tokens, d], the float32 residual:

    h        = RMSNorm(X) * g_in
    q        = h Wq                    -> H heads of q_nope | q_pe
    c, k_pe  = h Wkv_a                 (k_pe shared by the heads)
    k_nope,v = (RMSNorm(c) * g_kv) Wkv_b
    q_pe, k_pe rotated (RoPE: raw dims 2i, 2i+1 a pair at theta^(-2i/rope))
    X        = X + softmax((q . k) / sqrt(nope + rope), mask) v Wo
    h        = RMSNorm(X) * g_post
    dense:     X = X + W2 (SiLU(W1 h) * W3 h)
    MoE:       s = sigmoid(h Wr)  (float32);  idx = top-k(s + b_corr)
               w = scaling * s[idx] / (sum s[idx] + 1e-20)
               X = X + sum_j w_j E_idx_j(h) + S(h)

and the scores: RMSNorm(X[c]) * g_f . w_t + b_t for t = clicks, carts,
orders. Every product takes bfloat16 operands and sums in float32 (`mm`,
K6's softmax form, K9); the router is float32 (PyTorch's default
float32 product: TF32 off); RMSNorm, softmax, SiLU, the routing weights,
the combine and the residual are float32.

Parameters (`param_shapes`). Dense weights are [in, out]. A MoE layer's
experts are one [E + n_shared, 2 I, d] gate-and-up tensor and one
[E + n_shared, d, I] down tensor (a Linear's [out, in] each, I =
moe_intermediate_size): rows E.. hold the shared MLP (n_shared x I wide)
split into n_shared slices of I, so that K9 computes the routed and the
shared experts in one pair of launches, the shared ones at weight 1.

The token-wise work runs CHUNK_TOKENS tokens at a time, so that the
experts' rows of a chunk bound the memory (a chunk changes no token's
result). The buffers that span the batch (the residual, q, k, v, the
attention output) are taken in whole chunks and the experts' rows in a
whole chunk's, the last chunk's too, so that the caching allocator
meets the same few sizes batch after batch and reuses its blocks. A
chunk's MoE: the router, a
stable sort of its (token, slot) rows by expert, K9's gate-and-up launch
(each sorted row gathers its token's h) and its down launch (each row
scaled by its weight and written to its token's slot), then the sum over
a token's slots. The port serves a saved ranker (`save` / `load`, an
`.npz` read one array at a time); it does not train one.
"""
from __future__ import annotations

import dataclasses
import json
import zipfile
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from otto_tpu_torch.config import TYPES, MLAMoEConfig
from otto_tpu_torch.models.hstu import mm, pack
from otto_tpu_torch.models.ranker import _log_squash
from otto_tpu_torch.ops.kernels.dma_gather import gather_rows_hbm
from otto_tpu_torch.ops.kernels.grouped_gemm import grouped_gemm
from otto_tpu_torch.ops.kernels.softmax_attention import softmax_attention
from otto_tpu_torch.utils import timing

F32 = torch.float32
BF16 = torch.bfloat16

# valid tokens encoded; routed (token, expert) rows K9 computed (it also
# computes n_shared rows a token); the largest routed expert's rows in each
# K9 call, summed (over moe_rows / n_routed_experts: the load imbalance)
TOKENS = timing.counter("otto::rank.mla_moe_tokens")
MOE_ROWS = timing.counter("otto::rank.moe_rows")
MOE_MAX_ROWS = timing.counter("otto::rank.moe_max_rows")

# the parameters that are product operands, held in bfloat16 (the rest in
# float32), by the name before the layer index
PRODUCT_WEIGHTS = ("item_emb", "feat_proj", "head_w", "wq", "wkv_a", "wkv_b", "wo",
                   "mlp_w13", "mlp_w2", "moe_w13", "moe_w2")
META = "mla_moe_meta"
# tokens a chunk of the token-wise work: a 2,048-session batch of ~135
# tokens a session is 9 chunks, and a chunk's 8 x 32,768 expert rows take
# ~3 GB of activations at Moonlight-16B-A3B's widths
CHUNK_TOKENS = 32768


def _rows(n: int) -> int:
    """Rows to allocate for n tokens: whole chunks past one chunk."""
    return n if n <= CHUNK_TOKENS else -(-n // CHUNK_TOKENS) * CHUNK_TOKENS


def _base(name: str) -> str:
    return name.rsplit("_", 1)[0] if name[-1].isdigit() else name


def param_dtype(name: str) -> torch.dtype:
    return BF16 if _base(name) in PRODUCT_WEIGHTS else F32


def param_shapes(cfg: MLAMoEConfig, n_aids: int, n_features: int) -> Dict[str, tuple]:
    """Every parameter's shape, by its name in `save`'s file."""
    d, H = cfg.hidden_size, cfg.num_attention_heads
    nope, rope, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    E = cfg.n_routed_experts + cfg.n_shared_experts
    Ie = cfg.moe_intermediate_size
    out = {"item_emb": (n_aids, d), "type_emb": (3, d), "feat_proj": (n_features, d),
           "norm_mean": (n_features,), "norm_std": (n_features,), "final_norm": (d,),
           "head_w": (d, len(TYPES)), "head_b": (len(TYPES),)}
    for i in range(cfg.num_hidden_layers):
        out.update({f"in_norm_{i}": (d,), f"wq_{i}": (d, H * (nope + rope)),
                    f"wkv_a_{i}": (d, r + rope), f"kv_norm_{i}": (r,),
                    f"wkv_b_{i}": (r, H * (nope + dv)), f"wo_{i}": (H * dv, d),
                    f"post_norm_{i}": (d,)})
        if i < cfg.first_k_dense_replace:
            out.update({f"mlp_w13_{i}": (d, 2 * cfg.intermediate_size),
                        f"mlp_w2_{i}": (cfg.intermediate_size, d)})
        else:
            out.update({f"router_{i}": (d, cfg.n_routed_experts),
                        f"router_bias_{i}": (cfg.n_routed_experts,),
                        f"moe_w13_{i}": (E, 2 * Ie, d), f"moe_w2_{i}": (E, d, Ie)})
    return out


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * g, in float32."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def rope_tables(cfg: MLAMoEConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin [max_seq_len + 1, rope / 2] float32 at positions 0..max_seq_len:
    pair i turns at theta^(-2i / rope), as DeepSeek-V3's rotary embedding
    computes its frequencies."""
    dim = cfg.qk_rope_head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, dim, 2, device=device).float() / dim))
    freqs = torch.outer(torch.arange(cfg.max_seq_len + 1, device=device).float(), inv)
    return freqs.cos(), freqs.sin()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., 2m] float32, raw dims (2i, 2i + 1) pair i; cos / sin broadcast
    to [..., m]. -> the rotated pairs in DeepSeek-V3's de-interleaved layout
    (the first halves, then the second halves; q and k alike, so their dot
    products are those of the pairs)."""
    xe, xo = x[..., 0::2], x[..., 1::2]
    return torch.cat([xe * cos - xo * sin, xo * cos + xe * sin], -1)


def route(h: torch.Tensor, wr: torch.Tensor, bias: torch.Tensor, top_k: int, scaling: float):
    """h [n, d] float32, wr [d, E] float32, bias [E] float32 -> (idx [n, top_k]
    int64, weights [n, top_k] float32): sigmoid scores in float32; the bias
    only chooses the experts (noaux_tc with one group); the chosen scores
    normalised, then times `scaling`."""
    s = torch.sigmoid(torch.mm(h, wr))
    idx = torch.topk(s + bias, top_k, dim=1).indices
    w = s.gather(1, idx)
    return idx, w / (w.sum(1, keepdim=True) + 1e-20) * scaling


class _Stored:
    """One array of a saved ranker, read from its file on use."""

    def __init__(self, npz, key: str, shape: tuple, bf16: bool):
        self.npz, self.key, self.shape, self.bf16 = npz, key, shape, bf16

    def read(self) -> torch.Tensor:
        t = torch.from_numpy(self.npz[self.key])
        return t.view(BF16) if self.bf16 else t


def _tensor(v) -> torch.Tensor:
    return v.read() if isinstance(v, _Stored) else torch.as_tensor(v)


def _npz_shapes(path: str) -> Dict[str, tuple]:
    """Each array's shape, from its header alone."""
    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            with zf.open(name) as fh:
                version = np.lib.format.read_magic(fh)
                read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                        else np.lib.format.read_array_header_2_0)
                out[name[:-len(".npy")]] = tuple(read(fh)[0])
    return out


class _OnDevice:
    """The ranker's parameters on one device, each in its dtype
    (param_dtype); a tensor already there in that dtype is used as it is,
    not copied. Stored arrays are read and moved one at a time."""

    def __init__(self, params: Dict[str, object], cfg: MLAMoEConfig, device):
        p = {k: _tensor(v).to(device=device, dtype=param_dtype(k)) for k, v in params.items()}
        self.item_words = p["item_emb"].contiguous().view(torch.int32)
        self.type_emb = p["type_emb"]
        self.feat_proj = p["feat_proj"]
        self.norm_mean, self.norm_std = p["norm_mean"], p["norm_std"]
        self.final_norm, self.head_w, self.head_b = p["final_norm"], p["head_w"], p["head_b"]
        names = ("in_norm", "wq", "wkv_a", "kv_norm", "wkv_b", "wo", "post_norm", "mlp_w13",
                 "mlp_w2", "router", "router_bias", "moe_w13", "moe_w2")
        self.layers = [{n: p[f"{n}_{i}"] for n in names if f"{n}_{i}" in p}
                       for i in range(cfg.num_hidden_layers)]
        self.cos, self.sin = rope_tables(cfg, device)
        self.shared_ids = torch.arange(cfg.n_routed_experts,
                                       cfg.n_routed_experts + cfg.n_shared_experts,
                                       device=device)


@dataclasses.dataclass
class MLAMoERanker:
    """One MLA + MoE decoder ranker for every target type. `params` holds
    tensors (or arrays, or a saved file's arrays) named as `param_shapes`
    says; scoring moves them to the batch's device on first use, in
    param_dtype (nothing is copied where they already live)."""

    cfg: MLAMoEConfig
    params: Dict[str, object]
    feature_names: Tuple[str, ...]
    tasks: Tuple[str, ...] = TYPES
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        n_aids = int(self.params["item_emb"].shape[0])
        want = param_shapes(self.cfg, n_aids, len(self.feature_names))
        got = {k: tuple(v.shape) for k, v in self.params.items()}
        if got != want:
            wrong = sorted(set(got) ^ set(want)) or sorted(
                k for k in want if got[k] != want[k])
            raise ValueError(f"mla_moe: parameters do not fit {self.cfg}: {wrong[:6]}")

    def on(self, device) -> _OnDevice:
        key = str(torch.device(device))
        if key not in self._on_device:
            self._on_device[key] = _OnDevice(self.params, self.cfg, torch.device(device))
        return self._on_device[key]

    def predict_scores_multi(self, b) -> torch.Tensor:
        """A RetrievedBatch -> scores [n_tasks, S, C] float32 on its device
        (-inf at empty candidate slots)."""
        aid, ts, type_ = b.history_device()
        return self.encode(aid, ts, type_, b.cand_device(), b.feats)

    def encode(self, aid, ts, type_, cand, feats) -> torch.Tensor:
        """aid / ts / type_ [S, Lb] int32 left-aligned histories, cand [S, C]
        int32, feats [S, C, F] float32 -> scores [n_tasks, S, C] float32.
        Two syncs: the pack's token count, and the largest experts' rows
        once the scores are written."""
        cfg = self.cfg
        w = self.on(cand.device)
        S, C = cand.shape
        scores = torch.full((len(self.tasks), S, C), -torch.inf, dtype=F32, device=cand.device)
        with torch.no_grad(), timing.span("otto::rank.mla_moe"):
            pk = pack(aid, ts, type_, cand, cfg.max_seq_len)
            N = pk.n_tokens
            if N == 0:
                return scores
            ids = pk.ids
            if _rows(N) > N:   # whole chunks: the rows past N read item 0
                ids = torch.zeros(_rows(N), dtype=pk.ids.dtype, device=pk.ids.device)
                ids[:N] = pk.ids
            x = gather_rows_hbm(w.item_words, ids).view(BF16).float()[:N]
            x[pk.h_dst] += w.type_emb[pk.h_type]
            f = (_log_squash(feats[pk.c_sess, pk.c_slot]) - w.norm_mean) / w.norm_std
            x[pk.c_dst] += mm(f, w.feat_proj)
            # each token's position: its index in the session, L for candidates
            sess = torch.repeat_interleave(torch.arange(S, device=x.device),
                                           (pk.offsets[1:] - pk.offsets[:-1]).long(),
                                           output_size=N)
            local = torch.arange(N, device=x.device) - pk.offsets.long()[sess]
            pos = torch.minimum(local, pk.n_hist.long()[sess])
            cos, sin = w.cos[pos], w.sin[pos]
            TOKENS.add(N)
            max_rows = torch.zeros((), dtype=torch.int64, device=x.device)
            for i, lw in enumerate(w.layers):
                with timing.span("otto::rank.mla_moe.layer", index=i):
                    max_rows += self._layer(x, lw, pk, cos, sin)
            xc = rms_norm(x[pk.c_dst], w.final_norm, cfg.rms_norm_eps)
            scores[:, pk.c_sess, pk.c_slot] = mm(xc, w.head_w, w.head_b).t()
        MOE_MAX_ROWS.add(int(max_rows))   # the sync the scores' pull would make
        return scores

    @staticmethod
    def _chunks(N: int):
        return ((a, min(N, a + CHUNK_TOKENS)) for a in range(0, N, CHUNK_TOKENS))

    def _layer(self, x, lw, pk, cos, sin) -> torch.Tensor:
        """One layer on x in place. -> the largest routed expert's rows,
        summed over the chunks (a 0-d tensor on x's device)."""
        cfg = self.cfg
        N, d = x.shape
        H, nope, rope_dim = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        dv, r = cfg.v_head_dim, cfg.kv_lora_rank
        q = torch.empty((_rows(N), H, nope + rope_dim), dtype=BF16, device=x.device)[:N]
        k = torch.empty((_rows(N), H, nope + rope_dim), dtype=BF16, device=x.device)[:N]
        v = torch.empty((_rows(N), H, dv), dtype=BF16, device=x.device)[:N]
        for a, b in self._chunks(N):
            n = b - a
            c_, s_ = cos[a:b], sin[a:b]
            h = rms_norm(x[a:b], lw["in_norm"], cfg.rms_norm_eps)
            qf = mm(h, lw["wq"]).view(n, H, nope + rope_dim)
            qf[..., nope:] = rope(qf[..., nope:], c_[:, None], s_[:, None])
            q[a:b] = qf
            ckv = mm(h, lw["wkv_a"])
            kv = mm(rms_norm(ckv[:, :r], lw["kv_norm"], cfg.kv_norm_eps),
                    lw["wkv_b"]).view(n, H, nope + dv)
            k[a:b, :, :nope] = kv[..., :nope]
            k[a:b, :, nope:] = rope(ckv[:, r:], c_, s_)[:, None, :]
            v[a:b] = kv[..., nope:]
            del h, qf, ckv, kv
        y = softmax_attention(q, k, v, pk.offsets, pk.n_hist, (nope + rope_dim) ** -0.5,
                              out=torch.empty((_rows(N), H, dv), dtype=F32,
                                              device=x.device)[:N])
        del q, k, v
        max_rows = torch.zeros((), dtype=torch.int64, device=x.device)
        for a, b in self._chunks(N):
            x[a:b] += mm(y[a:b].view(b - a, H * dv), lw["wo"])
            h = rms_norm(x[a:b], lw["post_norm"], cfg.rms_norm_eps)
            if "mlp_w13" in lw:
                gu = mm(h, lw["mlp_w13"])
                I = cfg.intermediate_size
                x[a:b] += mm(F.silu(gu[:, :I]) * gu[:, I:], lw["mlp_w2"])
            else:
                out, m = self._moe(h, lw, min(N, CHUNK_TOKENS))
                x[a:b] += out
                max_rows += m
        return max_rows

    def _moe(self, h, lw, whole: int):
        """The chunk's experts, their rows taken for a chunk of `whole`
        tokens: -> (their sum with the shared MLP [n, d] float32, the
        largest routed expert's rows)."""
        cfg = self.cfg
        n, d = h.shape
        E, top = cfg.n_routed_experts, cfg.num_experts_per_tok
        slots = top + cfg.n_shared_experts
        w = self.on(h.device)
        with timing.span("otto::rank.mla_moe.router"):
            idx, wts = route(h, lw["router"], lw["router_bias"], top,
                             cfg.routed_scaling_factor)
        with timing.span("otto::rank.mla_moe.experts"):
            eid = torch.cat([idx, w.shared_ids.expand(n, -1)], 1).reshape(-1)
            wt = torch.cat([wts, torch.ones((n, slots - top), dtype=F32, device=h.device)], 1)
            order = torch.sort(eid, stable=True).indices
            counts = torch.bincount(eid, minlength=E + cfg.n_shared_experts)
            offsets = torch.zeros(E + cfg.n_shared_experts + 1, dtype=torch.int32,
                                  device=h.device)
            offsets[1:] = torch.cumsum(counts, 0)
            Ie = lw["moe_w2"].shape[2]
            act = grouped_gemm(h.to(BF16), lw["moe_w13"], offsets,
                               rows=(order // slots).int(), gate_up=True,
                               out=torch.empty((whole * slots, Ie), dtype=BF16,
                                               device=h.device)[:n * slots])
            out = torch.empty((whole * slots, d), dtype=F32, device=h.device)[:n * slots]
            grouped_gemm(act, lw["moe_w2"], offsets, out_rows=order.int(),
                         row_scale=wt.reshape(-1)[order], out=out)
            MOE_ROWS.add(n * top)
            return out.view(n, slots, d).sum(1), counts[:E].max()

    def save(self, path: str) -> None:
        """One `.npz`, written an array at a time: bfloat16 arrays as their
        16-bit words (the file's meta names them), with the config and
        feature names as JSON."""
        bf16 = []
        with zipfile.ZipFile(path, "w", allowZip64=True) as zf:
            for k, v in self.params.items():
                t = _tensor(v).detach().cpu()
                if t.dtype == BF16:
                    bf16.append(k)
                    t = t.view(torch.int16)
                with zf.open(k + ".npy", "w", force_zip64=True) as fh:
                    np.lib.format.write_array(fh, np.ascontiguousarray(t.numpy()))
            meta = {"config": dataclasses.asdict(self.cfg),
                    "feature_names": list(self.feature_names), "bf16": bf16}
            with zf.open(META + ".npy", "w") as fh:
                np.lib.format.write_array(fh, np.array(json.dumps(meta)))

    @staticmethod
    def load(path: str) -> "MLAMoERanker":
        """A ranker `save` wrote. Its arrays stay in the file until scoring
        moves them to a device, one at a time."""
        shapes = _npz_shapes(path)
        if META not in shapes:
            raise ValueError(f"{path} holds no MLA + MoE ranker (no {META})")
        z = np.load(path, allow_pickle=False)
        meta = json.loads(str(z[META]))
        bf16 = set(meta["bf16"])
        params = {k: _Stored(z, k, s, k in bf16) for k, s in shapes.items() if k != META}
        return MLAMoERanker(MLAMoEConfig(**meta["config"]), params,
                            tuple(meta["feature_names"]))

