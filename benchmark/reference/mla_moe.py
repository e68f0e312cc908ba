"""The plain reference of the MLA + MoE ranker (otto_tpu_torch/models/mla_moe.py):
plain torch in float32 with TF32 off, no kernel of the port and no jax.
It follows DeepSeek-V3's modeling code (the architecture of the
configuration's source): latent attention in its materialised form
(k_nope and v built from the latent), the rotary embedding as its
`apply_rotary_pos_emb` takes it (the rope dims de-interleaved, then
rotated by halves), the noaux_tc sigmoid router with one group, the
routed experts as a loop over the experts, and the shared experts as one
MLP of n_shared x moe_intermediate_size. Attention runs one session at a
time over its full [T, T] scores with the target-aware mask; the
token-wise work runs over every sampled token, in chunks that bound the
memory (a chunk changes no token's result).

`reference_scores` takes the sample that `sample_inputs` retrieved (the
frozen retrieval, benchmark/reference/retrieval.py, one microbatch of
the program's length buckets at a time) and runs it one layer at a time,
each layer's weights upcast to float32 for that layer only, so that it
fits beside the bfloat16 weights once the program's objects are freed.

Routing. A token whose k-th and (k+1)-th biased expert scores nearly
tie may be routed one way by the program (bfloat16 operands) and the
other by the reference, and the token's output then differs by a whole
expert's share. So a stream may take the program's recorded expert sets
(`given`): it computes its own router scores, weighs the given experts
by them, and reads each set's margin, how far the set lies from its own
top-k (0 where it is the top-k). A set the program chose well lies
within rounding of the reference's top-k; one chosen by a wrong rule
does not. The comparison judges the scores and the margins apart.

`precision` rounds every product's operands: "full" to bfloat16 (the
configuration's precision), "low" to float8 e4m3 (the control). The
router is float32 in both, as published. `fault` plants one wrong step
for the tests: "bias_in_weights" takes the correction bias into the
routing weights, "no_shared" drops the shared experts, "rope_pairs"
rotates raw dims (i, i + rope / 2) together instead of (2i, 2i + 1),
"tf32" rounds the router's float32 operands to TF32's 10 mantissa bits,
as a card computes a float32 product with TF32 left on. `cfg` is an
object with the configuration's keys as attributes.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.batching import iter_microbatches, pack_sessions
from benchmark.reference.check import RefSession, trim_params
from benchmark.reference.hstu import log_squash, no_tf32, operand
from benchmark.reference.retrieval import retrieve_batch

F32 = torch.float32
# tokens a chunk of the token-wise work
CHUNK = 16384
LAYER_WEIGHTS = ("in_norm", "wq", "wkv_a", "kv_norm", "wkv_b", "wo", "post_norm", "mlp_w13",
                 "mlp_w2", "router", "router_bias", "moe_w13", "moe_w2")


class Batch(NamedTuple):
    """One microbatch of the sample, its real rows only: padded histories as
    the program receives them, the frozen retrieval's candidates and
    features."""

    session: np.ndarray     # [n] session ids
    aid: torch.Tensor       # [n, Lb] int32, -1 past a session's events
    ts: torch.Tensor
    type: torch.Tensor
    length: np.ndarray      # [n] events
    cand: torch.Tensor      # [n, C] int32, -1 at empty slots
    feats: torch.Tensor     # [n, C, F] float32


def mm(a, b, precision):
    return torch.matmul(operand(a, precision), operand(b, precision))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(F32)


def rms_norm(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def rotate(x: torch.Tensor, pos: torch.Tensor, theta: float, fault: str = "") -> torch.Tensor:
    """DeepSeek-V3's apply_rotary_pos_emb on x [n, ..., dim] at positions
    pos [n]: the dims de-interleaved (2i, 2i + 1 -> i, i + dim / 2), then
    x * cos + rotate_half(x) * sin with cos = cos([freqs, freqs])."""
    dim = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=x.device).float() / dim))
    freqs = pos.float()[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], -1)
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (dim,)
    cos, sin = emb.cos().view(shape), emb.sin().view(shape)
    if fault != "rope_pairs":
        x = x.reshape(*x.shape[:-1], dim // 2, 2).transpose(-1, -2).reshape(x.shape)
    rot = torch.cat([-x[..., dim // 2:], x[..., :dim // 2]], -1)
    return x * cos + rot * sin


def route(h, wr, bias, cfg, fault: str = "", given: Optional[torch.Tensor] = None):
    """-> (idx [n, k], weights [n, k], margin [n]): sigmoid scores of the
    float32 product, top-k of scores + bias (or the `given` sets), the
    chosen scores normalised and scaled. margin: how far the chosen set
    lies from this router's own top-k, max(0, the best unchosen biased
    score - the worst chosen one); 0 where it is the top-k."""
    if fault == "tf32":
        h, wr = tf32(h), tf32(wr)
    s = torch.sigmoid(h @ wr)
    z = s + bias
    idx = (torch.topk(z, cfg.num_experts_per_tok, dim=-1).indices if given is None
           else given.to(h.device).long())
    chosen = torch.zeros_like(z, dtype=torch.bool).scatter_(1, idx, True)
    margin = (z.masked_fill(chosen, -torch.inf).max(1).values
              - z.masked_fill(~chosen, torch.inf).min(1).values).clamp(min=0)
    w = (z if fault == "bias_in_weights" else s).gather(1, idx)
    return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor, margin


class Routing:
    """One stream's routing, a MoE layer at a time: the expert sets it used
    ([tokens, k], the sample's token order) and their margins ([tokens])."""

    def __init__(self):
        self.sets: List[torch.Tensor] = []
        self.margins: List[torch.Tensor] = []

    def flip_share(self) -> Optional[float]:
        """% of (token, MoE layer) sets that are not the stream's own top-k."""
        n = sum(m.numel() for m in self.margins)
        return 100.0 * sum(int((m > 0).sum()) for m in self.margins) / n if n else None

    def max_margin(self) -> Optional[float]:
        return max(float(m.max()) for m in self.margins if m.numel()) \
            if any(m.numel() for m in self.margins) else None


def moe(h, lw, cfg, precision, fault, given: Optional[torch.Tensor] = None):
    """The routed experts one at a time, then the shared MLP. -> (out, the
    sets used, their margins)."""
    E, I = cfg.n_routed_experts, cfg.moe_intermediate_size
    idx, w, margin = route(h, lw["router"], lw["router_bias"], cfg, fault, given)
    out = torch.zeros_like(h)
    for e in range(E):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        gu = mm(h[tok], lw["moe_w13"][e].t(), precision)
        y = mm(F.silu(gu[:, :I]) * gu[:, I:], lw["moe_w2"][e].t(), precision)
        out.index_add_(0, tok, y * w[tok, slot, None])
    if fault != "no_shared":
        shared = range(E, E + cfg.n_shared_experts)
        gate = torch.cat([lw["moe_w13"][e][:I] for e in shared])
        up = torch.cat([lw["moe_w13"][e][I:] for e in shared])
        down = torch.cat([lw["moe_w2"][e] for e in shared], 1)
        g = mm(h, gate.t(), precision)
        u = mm(h, up.t(), precision)
        out = out + mm(F.silu(g) * u, down.t(), precision)
    return out, idx, margin


def layer(x, lw, cfg, offsets, Ls, pos, precision, fault="", given=None):
    """One decoder layer over every sampled token -> (the new residual, and
    in a MoE layer a Routing's sets and margins over the tokens, else None);
    `given`: the expert sets [tokens, k] a MoE layer takes, or None."""
    N = x.shape[0]
    H, nope, rope = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dv, r = cfg.v_head_dim, cfg.kv_lora_rank
    q = torch.empty((N, H, nope + rope), dtype=F32, device=x.device)
    k = torch.empty_like(q)
    v = torch.empty((N, H, dv), dtype=F32, device=x.device)
    for a in range(0, N, CHUNK):
        b = min(N, a + CHUNK)
        h = rms_norm(x[a:b], lw["in_norm"], cfg.rms_norm_eps)
        qf = mm(h, lw["wq"], precision).view(b - a, H, nope + rope)
        q[a:b] = torch.cat([qf[..., :nope], rotate(qf[..., nope:], pos[a:b], cfg.rope_theta,
                                                    fault)], -1)
        ckv = mm(h, lw["wkv_a"], precision)
        kv = mm(rms_norm(ckv[:, :r], lw["kv_norm"], cfg.kv_norm_eps), lw["wkv_b"],
                precision).view(b - a, H, nope + dv)
        k_pe = rotate(ckv[:, r:], pos[a:b], cfg.rope_theta, fault)
        k[a:b] = torch.cat([kv[..., :nope], k_pe[:, None, :].expand(b - a, H, rope)], -1)
        v[a:b] = kv[..., nope:]
    y = torch.empty((N, H * dv), dtype=F32, device=x.device)
    scale = math.sqrt(nope + rope)
    for s, L in enumerate(Ls):
        o, T = offsets[s], offsets[s + 1] - offsets[s]
        qs, ks, vs = (t[o:o + T].transpose(0, 1) for t in (q, k, v))
        sc = mm(qs, ks.transpose(1, 2), precision) / scale                 # [H, T, T]
        mask = torch.zeros((T, T), dtype=torch.bool, device=x.device)
        mask[:L, :L] = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
        mask[L:, :L] = True
        mask[L:, L:] = torch.eye(T - L, dtype=torch.bool, device=x.device)
        a_ = torch.softmax(sc.masked_fill(~mask, -torch.inf), -1)
        y[o:o + T] = mm(a_, vs, precision).transpose(0, 1).reshape(T, H * dv)
    del q, k, v
    out = torch.empty_like(x)
    sets, margins = [], []
    for a in range(0, N, CHUNK):
        b = min(N, a + CHUNK)
        xa = x[a:b] + mm(y[a:b], lw["wo"], precision)
        h = rms_norm(xa, lw["post_norm"], cfg.rms_norm_eps)
        if "mlp_w13" in lw:
            gu = mm(h, lw["mlp_w13"], precision)
            I = cfg.intermediate_size
            xa = xa + mm(F.silu(gu[:, :I]) * gu[:, I:], lw["mlp_w2"], precision)
        else:
            y_, idx, margin = moe(h, lw, cfg, precision, fault,
                                  given[a:b] if given is not None else None)
            xa = xa + y_
            sets.append(idx)
            margins.append(margin)
        out[a:b] = xa
    if not sets:
        return out, None
    return out, (torch.cat(sets), torch.cat(margins))


def forward(p: dict, cfg, sessions: Sequence[tuple], streams: Sequence = ("full",),
            fault: str = "", routing: Optional[Dict[str, Routing]] = None
            ) -> Dict[str, List[torch.Tensor]]:
    """sessions: (aid, type_, cand, feats) of each session: its events in
    time order, its valid candidates, their [C, F] features; p the
    ranker's parameters (models/mla_moe.py::param_shapes' names, any
    float dtype). streams: each a precision (named after it, routing by
    its own top-k) or (name, precision, given), where given is None, the
    expert sets to take (one [tokens, k] tensor a MoE layer, over the
    sessions' tokens, history then candidates, in order), or the name of
    an earlier stream whose sets to take. -> {name: [scores [3, C]
    float32 a session]}. With `routing` a dict, each stream's Routing is
    put under its name."""
    no_tf32()
    streams = [(s, s, None) if isinstance(s, str) else tuple(s) for s in streams]
    dev = p["item_emb"].device
    xs, Ls, Cs = {name: [] for name, _, _ in streams}, [], []
    for aid, type_, cand, feats in sessions:
        L = min(len(aid), cfg.max_seq_len)
        aid = torch.as_tensor(np.asarray(aid)[len(aid) - L:], device=dev).long()
        type_ = torch.as_tensor(np.asarray(type_)[len(type_) - L:], device=dev).long()
        cand = torch.as_tensor(np.asarray(cand), device=dev).long()
        f = (log_squash(torch.as_tensor(feats, device=dev)) - p["norm_mean"].float()) \
            / p["norm_std"].float()
        for name, prec, _ in streams:
            x_h = p["item_emb"][aid].float() + p["type_emb"][type_].float()
            x_c = p["item_emb"][cand].float() + mm(f, p["feat_proj"].float(), prec)
            xs[name].append(torch.cat([x_h, x_c]))
        Ls.append(L)
        Cs.append(len(cand))
    offsets = np.concatenate([[0], np.cumsum(np.asarray(Ls) + np.asarray(Cs))]).tolist()
    pos = torch.cat([torch.cat([torch.arange(L, device=dev), torch.full((C,), L, device=dev)])
                     for L, C in zip(Ls, Cs)])
    x = {name: torch.cat(xs[name]) for name, _, _ in streams}
    del xs
    logs = {name: Routing() for name, _, _ in streams}
    for i in range(cfg.num_hidden_layers):
        lw = {n: p[f"{n}_{i}"].float() for n in LAYER_WEIGHTS if f"{n}_{i}" in p}
        moe_i = i - cfg.first_k_dense_replace
        for name, prec, given in streams:
            sets = None
            if moe_i >= 0 and isinstance(given, str):
                sets = logs[given].sets[moe_i]
            elif moe_i >= 0 and given is not None:
                sets = given[moe_i]
            x[name], r = layer(x[name], lw, cfg, offsets, Ls, pos, prec, fault, sets)
            if r is not None:
                logs[name].sets.append(r[0])
                logs[name].margins.append(r[1])
        del lw
    if routing is not None:
        routing.update(logs)
    out = {}
    for name, prec, _ in streams:
        xc = torch.cat([x[name][offsets[s] + L:offsets[s + 1]] for s, L in enumerate(Ls)])
        sc = mm(rms_norm(xc, p["final_norm"].float(), cfg.rms_norm_eps), p["head_w"].float(),
                prec) + p["head_b"].float()
        out[name] = list(torch.split(sc.t(), Cs, dim=1))
    return out


def sample_inputs(cols, cluster_of: Dict[int, int], emb_of: Dict[int, np.ndarray], ctx,
                  retrieval: dict, batch: int) -> List[Batch]:
    """cols: (session, aid, ts, type) of the sampled sessions, sorted by
    (session, ts); cluster_of / emb_of: each session's cluster and
    embedding. -> the frozen retrieval's microbatches, real rows only."""
    dev = ctx.aid_emb.device
    trim = trim_params(retrieval, dev)
    out = []

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    for p in pack_sessions(*cols, bucket_lens=retrieval["session_len_buckets"]):
        for mb in iter_microbatches(p, min(batch, p.n_sessions)):
            real = np.nonzero(mb.session >= 0)[0]
            cl = np.array([cluster_of.get(int(s), 0) for s in mb.session], np.int32)
            none = np.zeros(ctx.aid_emb.shape[1], np.float32)
            em = np.stack([emb_of.get(int(s), none) for s in mb.session]).astype(np.float32)
            cand, feats, _ = retrieve_batch(
                (put(mb.aid), put(mb.ts), put(mb.type)), ctx, put(cl), put(em), trim,
                retrieval["max_session_aids"], retrieval["max_candidates"])
            rows = torch.from_numpy(real).to(dev)
            out.append(Batch(mb.session[real], put(mb.aid[real]), put(mb.ts[real]),
                             put(mb.type[real]), mb.length[real], cand[rows], feats[rows]))
    return out


def session_list(sample: Sequence[Batch]):
    """-> (session ids, (aid, type_, cand, feats) of each) in the sample's
    order; the candidates are the valid slots in slot order."""
    ids, rows = [], []
    for b in sample:
        cand = b.cand.cpu().numpy()
        for i, s in enumerate(b.session):
            n = int(b.length[i])
            ok = np.nonzero(cand[i] >= 0)[0]
            ids.append(int(s))
            rows.append((b.aid[i, :n].cpu().numpy(), b.type[i, :n].cpu().numpy(), cand[i][ok],
                         b.feats[i][torch.from_numpy(ok).to(b.feats.device)]))
    return ids, rows


def reference_scores(sample: Sequence[Batch], params: dict, cfg,
                     streams: Sequence = ("full",),
                     routing: Optional[Dict[str, Routing]] = None) -> Dict[int, RefSession]:
    """{session: RefSession} with scores [3, n] per stream name over the
    sample; `streams` and `routing` as `forward` takes them."""
    ids, rows = session_list(sample)
    if not ids:
        return {}
    sc = forward(params, cfg, rows, streams, routing=routing)
    return {s: RefSession(rows[j][2], {name: sc[name][j].cpu().numpy() for name in sc})
            for j, s in enumerate(ids)}
