"""Skip-gram negative-sampling item embeddings (C8).

Counterpart of otto_tpu/models/word2vec.py: the vocabulary, the model
container (`embedding_by_aid`, `save` / `load` of otto_tpu's `.npz`) and
both SGNS trainers.

`train_word2vec_device` uploads the corpus once as a flat ragged word
stream and samples every step's (center, context, negatives) on the
device. Four step kinds, chosen as otto_tpu chooses them:
  block  (chunk negatives, block_k > 1; the production path at >= 100k
         words or >= 5M positions): each sampled center takes block_k
         contexts from its dynamic window, negatives come from Walker
         alias tables, shared by chunks of 256 pairs; Adagrad, or plain
         SGD with otto_tpu's linearly falling rate (optimizer="sgd");
  chunk  the same shared negatives over per-pair samples, drawn by CDF
         search;
  fused  (OTTO_W2V_FUSED=1, chunk negatives, one device) the chunk step
         on tables of [V, D+1] rows whose last column is the row's Adagrad
         accumulator (fuse_params): two row gathers and two row scatters a
         step instead of four of each, bit-equal to the chunk step;
  pair   `negatives` fresh draws per pair, dense whole-table gradients and
         whole-table Adagrad (small corpora).
Every kind but block trains with Adagrad whatever cfg.optimizer says, as
otto_tpu's do.
`train_word2vec` (sampler="host") streams numpy pairs per epoch
(`skipgram_pairs`, gensim's dynamic window and subsampling) through
`sgns_step` with a linearly decaying lr.

Every step takes its random numbers from a `draws(epoch, step)` hook, a
dict of named tensors; the default hook reads a torch.Generator seeded
from cfg.seed, and tests feed otto_tpu's threefry draws through it. The
starting table comes from `init_params`, which takes an injected start.

Row updates are deterministic on every device (`_add_rows`): a row's
duplicate updates are summed exactly in int64 fixed point, then rounded
once, never summed by float atomics. otto_tpu's XLA scatter adds them one
by one in batch order, so the two agree to float32 rounding.

Model-parallel training (`mesh_ctx` with a model axis > 1, otto_tpu's
make_sgns_epoch_mp): the rows of every table split over the model ranks
(padded to a multiple of them), each rank holding its rows plus one
scratch row. Every rank draws the same index stream (chunk negatives,
per-pair sampler); a gather is the model ranks' masked local gathers
summed (all_reduce: one owner, so exact), and each rank adds only its
own rows' updates, from the same fixed-point scale as one device: the
tables equal one device's bit for bit.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from otto_tpu_torch.config import Word2VecConfig
from otto_tpu_torch.data.schema import Events
from otto_tpu_torch.device import resolve
from otto_tpu_torch.parallel.mesh import gather_equal
from otto_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

log = logging.getLogger(__name__)

# negatives are shared within chunks of this many pairs, each chunk drawing
# negatives * _SHARED_NEG_FACTOR ids (otto_tpu's constants)
_NEG_CHUNK = 256
_SHARED_NEG_FACTOR = 8

Draws = Callable[[int, int], Dict[str, torch.Tensor]]


class Vocab(NamedTuple):
    """aid <-> dense word-index maps, most frequent word first."""

    aid_of_word: np.ndarray   # [V] int32: word idx -> aid
    word_of_aid: np.ndarray   # [n_aids] int32: aid -> word idx, -1 if absent
    counts: np.ndarray        # [V] int64 word frequencies

    @property
    def size(self) -> int:
        return len(self.aid_of_word)


def build_vocab(
    ev: Events, types: Tuple[int, ...], min_count: int,
    n_aids: Optional[int] = None,
) -> Vocab:
    """The words are the aids seen at least `min_count` times in events of
    `types`, by count descending, ties by aid."""
    m = np.isin(ev.type, np.asarray(types, np.int8))
    aids = ev.aid[m]
    n_aids = n_aids or (int(ev.aid.max()) + 1)
    counts = np.bincount(aids, minlength=n_aids)
    kept_aids = np.nonzero(counts >= min_count)[0]
    order = np.argsort(-counts[kept_aids], kind="stable")
    aid_of_word = kept_aids[order].astype(np.int32)
    word_of_aid = np.full(n_aids, -1, np.int32)
    word_of_aid[aid_of_word] = np.arange(len(aid_of_word), dtype=np.int32)
    return Vocab(aid_of_word, word_of_aid, counts[aid_of_word].astype(np.int64))


@dataclasses.dataclass
class TrainReport:
    """What a training ran: the step kind ("block", "chunk", "fused",
    "pair" or "host"), vocabulary size, corpus positions (host: pairs of
    the last epoch), steps per epoch, epochs run (after a resume, the
    rest), pairs sampled per step, each epoch's mean step loss, the
    optimizer the steps applied ("adagrad" or "sgd") and the seconds of
    the step loops alone (device trainers: from a synchronised device to
    each epoch's loss read, checkpoints left out)."""

    mode: str
    words: int
    positions: int
    steps_per_epoch: int
    epochs: int
    pairs_per_step: int
    epoch_loss: List[float]
    optimizer: str = "adagrad"
    loop_s: float = 0.0


@dataclasses.dataclass
class Word2Vec:
    """A trained model: vocabulary + input embeddings (and, when trained
    here, what the training ran)."""

    cfg: Word2VecConfig
    vocab: Vocab
    emb: np.ndarray  # [V, dim] float32, row i is word i
    report: Optional[TrainReport] = None

    def embedding_by_aid(self, n_aids: int) -> np.ndarray:
        """[n_aids, dim] float32 table by aid, zeros for aids without a
        word."""
        out = np.zeros((n_aids, self.emb.shape[1]), np.float32)
        out[self.vocab.aid_of_word] = self.emb
        return out

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            aid_of_word=self.vocab.aid_of_word,
            word_of_aid=self.vocab.word_of_aid,
            counts=self.vocab.counts,
            emb=self.emb,
        )

    @staticmethod
    def load(path: str, cfg: Word2VecConfig) -> "Word2Vec":
        z = np.load(path)
        vocab = Vocab(z["aid_of_word"], z["word_of_aid"], z["counts"])
        emb = z["emb"]
        if emb.ndim != 2 or emb.shape[0] != vocab.size:
            raise ValueError(
                f"{path}: emb {emb.shape} does not match {vocab.size} words"
            )
        return Word2Vec(cfg, vocab, emb)


# ---------------------------------------------------------------------------
# host preparation (numpy, bit-equal to otto_tpu's)
# ---------------------------------------------------------------------------
def flat_corpus(ev: Events, vocab: Vocab, types) -> Tuple[np.ndarray, np.ndarray]:
    """Events grouped by session -> (words [N] int32, cum_len [S+1] int32):
    sessions as contiguous runs of word ids, words outside the vocabulary
    dropped, then sessions shorter than 2 words (they make no pair)."""
    m = np.isin(ev.type, np.asarray(types, np.int8))
    sess = ev.session[m]
    words = vocab.word_of_aid[ev.aid[m]]
    keep = words >= 0
    sess, words = sess[keep], words[keep]
    if len(words) == 0:
        return np.zeros(0, np.int32), np.zeros(1, np.int32)
    boundary = np.empty(len(sess), bool)
    boundary[0] = True
    np.not_equal(sess[1:], sess[:-1], out=boundary[1:])
    starts = np.flatnonzero(boundary)
    lens = np.diff(np.append(starts, len(sess)))
    keep_run = lens >= 2
    if not keep_run.all():
        words = words[np.repeat(keep_run, lens)]
        lens = lens[keep_run]
    cum = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=cum[1:])
    if cum[-1] > np.iinfo(np.int32).max:
        raise ValueError("corpus exceeds int32 offsets")
    return words.astype(np.int32), cum.astype(np.int32)


def pack_position_info(cum: np.ndarray) -> np.ndarray:
    """cum_len [S+1] -> [N] int32 (position in session << 16) | session
    length (capped at 0xFFFF), so one gather locates a sampled position."""
    lens = np.diff(cum).astype(np.int64)
    n = int(cum[-1])
    pos_in = np.arange(n, dtype=np.int64) - np.repeat(cum[:-1].astype(np.int64), lens)
    slen = np.repeat(np.minimum(lens, 0xFFFF), lens)
    return ((pos_in << 16) | slen).astype(np.int32)


def make_alias(counts: np.ndarray, ns_exponent: float = 0.75):
    """Walker alias tables of the unigram^ns_exponent distribution:
    (prob [V] f32, alias [V] i32), Vose's construction; a draw is
    j ~ U{0..V-1}, u ~ U[0, 1): u < prob[j] ? j : alias[j]."""
    p = np.asarray(counts, np.float64) ** ns_exponent
    p = p / p.sum()
    V = len(p)
    scaled = p * V
    alias = np.zeros(V, np.int32)
    prob = np.ones(V, np.float32)
    small = [i for i in range(V) if scaled[i] < 1.0]
    large = [i for i in range(V) if scaled[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    return prob, alias


def make_neg_cdf(counts: np.ndarray, ns_exponent: float = 0.75) -> np.ndarray:
    """[V] float32 CDF of the unigram^ns_exponent distribution."""
    p = counts.astype(np.float64) ** ns_exponent
    cdf = np.cumsum(p / p.sum())
    cdf[-1] = 1.0
    return cdf.astype(np.float32)


def keep_probs(counts: np.ndarray, subsample_t: float) -> np.ndarray:
    """[V] float32 frequent-word keep probability (gensim's formula);
    all ones with subsample_t = 0."""
    if subsample_t <= 0:
        return np.ones(len(counts), np.float32)
    freq = counts / max(counts.sum(), 1)
    r = subsample_t / np.maximum(freq, 1e-12)
    return np.minimum(1.0, np.sqrt(r) + r).astype(np.float32)


def negative_mode(cfg: Word2VecConfig, n_words: int, positions: int) -> str:
    """cfg.neg_sharing, with 'auto' -> 'chunk' at >= 100k words or >= 5M
    corpus positions (pair mode's dense steps stream the whole table),
    else 'pair'."""
    if cfg.neg_sharing != "auto":
        return cfg.neg_sharing
    return "chunk" if n_words >= 100_000 or positions >= 5_000_000 else "pair"


def skipgram_pairs(ev: Events, vocab: Vocab, types: Tuple[int, ...], window: int,
                   subsample_t: float, rng: np.random.Generator
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Host pairs with gensim semantics: per-position dynamic window
    b ~ U{1..window}, frequent-word subsampling with threshold t; shuffled.
    -> (centers, contexts) int32 word ids."""
    m = np.isin(ev.type, np.asarray(types, np.int8))
    sess = ev.session[m]
    words = vocab.word_of_aid[ev.aid[m]]
    keep = words >= 0
    sess, words = sess[keep], words[keep]

    if subsample_t > 0:
        freq = vocab.counts / vocab.counts.sum()
        keep_prob = np.minimum(
            1.0, np.sqrt(subsample_t / np.maximum(freq, 1e-12))
            + subsample_t / np.maximum(freq, 1e-12)
        )
        keep = rng.random(len(words)) < keep_prob[words]
        sess, words = sess[keep], words[keep]

    if len(words) == 0:
        return np.array([], np.int32), np.array([], np.int32)

    boundary = np.empty(len(sess), bool)
    boundary[0] = True
    boundary[1:] = sess[1:] != sess[:-1]
    sess_start_idx = np.maximum.accumulate(np.where(boundary, np.arange(len(sess)), 0))
    ends = np.append(np.nonzero(boundary)[0][1:], len(sess))
    end_idx = ends[np.cumsum(boundary) - 1]

    centers, contexts = [], []
    b = rng.integers(1, window + 1, size=len(words))
    pos = np.arange(len(words))
    for off in range(1, window + 1):
        ok = b >= off
        j = pos + off
        sel = ok & (j < end_idx)
        centers.append(words[pos[sel]])
        contexts.append(words[j[sel]])
        j2 = pos - off
        sel2 = ok & (j2 >= sess_start_idx)
        centers.append(words[pos[sel2]])
        contexts.append(words[j2[sel2]])
    c = np.concatenate(centers).astype(np.int32)
    x = np.concatenate(contexts).astype(np.int32)
    perm = rng.permutation(len(c))
    return c[perm], x[perm]


# ---------------------------------------------------------------------------
# parameters and draws
# ---------------------------------------------------------------------------
class SGNSParams(NamedTuple):
    """The trained state, updated in place: tables [V, D] and per-row
    Adagrad accumulators [V], float32."""

    emb_in: torch.Tensor
    emb_out: torch.Tensor
    acc_in: torch.Tensor
    acc_out: torch.Tensor


def _seed32(x: int) -> int:
    # a CPU torch.Generator keeps 32 bits of its seed
    return int(x) % (1 << 32)


def init_params(vocab_size: int, dim: int, seed: int, device,
                start: Optional[np.ndarray] = None) -> SGNSParams:
    """emb_in uniform in [-0.5, 0.5) / dim (from a torch.Generator seeded
    with `seed`, or `start` [V, dim] when given), emb_out zeros,
    accumulators 1e-6."""
    dev = torch.device(device)
    if start is None:
        g = torch.Generator(device=dev).manual_seed(_seed32(seed))
        emb_in = (torch.rand((vocab_size, dim), generator=g, device=dev) - 0.5) / dim
    else:
        if np.shape(start) != (vocab_size, dim):
            raise ValueError(f"start {np.shape(start)} != ({vocab_size}, {dim})")
        emb_in = torch.tensor(np.asarray(start, np.float32), device=dev)
    return SGNSParams(
        emb_in=emb_in,
        emb_out=torch.zeros((vocab_size, dim), device=dev),
        acc_in=torch.full((vocab_size,), 1e-6, device=dev),
        acc_out=torch.full((vocab_size,), 1e-6, device=dev),
    )


def block_draws(gen: torch.Generator, n_centers: int, k: int, window: int,
                n_positions: int, n_words: int, n_pool: int) -> Dict[str, torch.Tensor]:
    """One block step's draws: center positions `flat`, reduced windows
    `b` in 1..window, raw offsets `off` in 0..window-1, `sign` bits,
    subsampling uniforms `keep` [C, k+1], alias columns `neg_j` and
    uniforms `neg_u` for the n_pool negatives."""
    dev = gen.device

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    def u(shape):
        return torch.rand(shape, generator=gen, device=dev)

    return {"flat": ri(0, n_positions, (n_centers,)),
            "b": ri(1, window + 1, (n_centers,)),
            "off": ri(0, window, (n_centers, k)),
            "sign": u((n_centers, k)) < 0.5,
            "keep": u((n_centers, k + 1)),
            "neg_j": ri(0, n_words, (n_pool,)),
            "neg_u": u((n_pool,))}


def pair_draws(gen: torch.Generator, batch: int, window: int,
               neg_shape: Tuple[int, ...]) -> Dict[str, torch.Tensor]:
    """One pair / chunk step's draws: position uniforms `pos_u`, reduced
    windows `b` and offsets `off` in 1..window, `sign` bits, subsampling
    uniforms `keep` [B, 2] and negative CDF uniforms `neg_u` [neg_shape]."""
    dev = gen.device

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    def u(shape):
        return torch.rand(shape, generator=gen, device=dev)

    return {"pos_u": u((batch,)), "b": ri(1, window + 1, (batch,)),
            "off": ri(1, window + 1, (batch,)), "sign": u((batch,)) < 0.5,
            "keep": u((batch, 2)), "neg_u": u(neg_shape)}


def host_draws(gen: torch.Generator, batch: int, n_negs: int) -> Dict[str, torch.Tensor]:
    """One host step's negative CDF uniforms `neg_u` [B, n_negs]."""
    return {"neg_u": torch.rand((batch, n_negs), generator=gen, device=gen.device)}


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------
class TableShard(NamedTuple):
    """A model rank's rows [v0, v0 + vs) of every table, held as [vs + 1]
    rows: the last one is scratch, where other ranks' ids land."""

    v0: int
    vs: int
    group: object


def _local_ids(ids: torch.Tensor, shard: Optional[TableShard]):
    """-> (row of each id in this rank's table, owned mask or None)."""
    if shard is None:
        return ids, None
    own = (ids >= shard.v0) & (ids < shard.v0 + shard.vs)
    return torch.where(own, ids - shard.v0, shard.vs), own


def _take(table: torch.Tensor, ids: torch.Tensor,
          shard: Optional[TableShard] = None) -> torch.Tensor:
    """table[ids]; on a shard, the model ranks' owned rows summed."""
    loc, own = _local_ids(ids, shard)
    rows = table[loc]
    if shard is None:
        return rows
    rows = torch.where(own if rows.dim() == 1 else own[:, None], rows, 0.0)
    dist.all_reduce(rows, group=shard.group)
    return rows


def _fixed_scale(rows: torch.Tensor, n: int, wide: bool = False) -> torch.Tensor:
    """The power of two (float32, on rows' device) that puts the sum of n
    rows as large as `rows` within int64: 2^(62 - e) for |rows| * n <
    2^e. `wide` takes the product in float64, so that rows near float32's
    largest values still give a finite scale."""
    amax = rows.abs().amax()
    _, e = torch.frexp(amax.double() * n if wide else amax * n)
    return torch.ldexp(torch.ones((), device=rows.device), (62 - e).clamp(max=126))


def _fixed_sums(ids: torch.Tensor, rows: torch.Tensor, shape,
                shard: Optional[TableShard] = None, wide: bool = False):
    """Per-id sums of rows, exact, so in no particular order: the rows are
    scaled by one power of two into int64 fixed point (room for the sum of
    all of them, _fixed_scale) and added with integer index_add_, with no
    sort and no host sync. -> (int64 sums of `shape`, the float32 scale).
    On a shard the scale is that of all rows, and only owned ids are
    summed."""
    scale = _fixed_scale(rows, ids.shape[0], wide)
    fixed = torch.zeros(shape, dtype=torch.int64, device=rows.device)
    fixed.index_add_(0, _local_ids(ids, shard)[0], torch.round(rows * scale).to(torch.int64))
    return fixed, scale


def _row_sums(ids: torch.Tensor, rows: torch.Tensor, shape) -> torch.Tensor:
    """A dense float32 table of `shape` holding each id's rows summed
    exactly, then rounded once."""
    fixed, scale = _fixed_sums(ids, rows, shape)
    return fixed.to(torch.float32) / scale


def _add_rows(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
              shard: Optional[TableShard] = None) -> None:
    """table[ids] += rows, each id's rows summed exactly and rounded once
    before the add (_fixed_sums): the same on every device, in any order.
    On a shard, other ranks' ids write the scratch row."""
    fixed, scale = _fixed_sums(ids, rows, table.shape, shard)
    loc = _local_ids(ids, shard)[0]
    # duplicate ids write the same value
    table[loc] = table[loc] + fixed[loc].to(table.dtype) / scale


def _add_rows_unbounded(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor) -> None:
    """_add_rows for rows that may be inf, NaN or near float32's largest
    values (a diverging plain-SGD step): the finite entries are summed in
    fixed point at a scale that stays finite (_fixed_scale's `wide`), and
    the others are added in float, where a sum of infinities and NaNs is
    the same in any order. So a row goes inf or NaN where float adds take
    it there, and a fixed-point sum never wraps into finite values."""
    finite = torch.isfinite(rows)
    fixed, scale = _fixed_sums(ids, torch.where(finite, rows, 0.0), table.shape, wide=True)
    odd = torch.zeros_like(table).index_add_(0, ids, torch.where(finite, 0.0, rows))
    table[ids] = table[ids] + (fixed[ids].to(table.dtype) / scale + odd[ids])


def _add_fused_rows(tab: torch.Tensor, ids: torch.Tensor, upd: torch.Tensor,
                    gsq: torch.Tensor, rows: torch.Tensor) -> None:
    """tab[ids, :D] += upd and tab[ids, D] += gsq on a fused table whose
    rows at ids (before the add) are `rows`: each part scaled into fixed
    point as _add_rows scales it on its own table, then one int64
    index_add_ of [M, D+1] rows, so both parts equal _add_rows' bit for
    bit."""
    n = ids.shape[0]
    s_upd, s_gsq = _fixed_scale(upd, n), _fixed_scale(gsq, n)
    fixed = torch.zeros(tab.shape, dtype=torch.int64, device=tab.device)
    fixed.index_add_(0, ids, torch.cat([torch.round(upd * s_upd),
                                        torch.round(gsq * s_gsq)[:, None]], 1).to(torch.int64))
    scale = torch.cat([s_upd.expand(upd.shape[1]), s_gsq[None]])
    # duplicate ids write the same value
    tab[ids] = rows + fixed[ids].to(tab.dtype) / scale


def _adagrad_rows(g: torch.Tensor, acc: torch.Tensor, lr: float):
    """Per-row Adagrad of row occurrences with gradients g [M, D] whose
    rows' accumulators before the step are acc [M]: -> (the update
    -lr * g / sqrt(acc + mean(g^2) + 1e-8), the accumulator's increment
    mean(g^2))."""
    gsq = torch.mean(g ** 2, dim=1)
    scale = lr * torch.rsqrt(acc + gsq + 1e-8)
    return -scale[:, None] * g, gsq


def _sparse_adagrad(p: SGNSParams, c_ids, g_c, out_ids, g_out, lr: float,
                    shard: Optional[TableShard] = None) -> None:
    """Per-row Adagrad on the touched rows: each row occurrence is scaled
    by its row's pre-step accumulator plus its own squared gradient mean,
    then the occurrences are summed into the tables."""
    upd_c, gsq_c = _adagrad_rows(g_c, _take(p.acc_in, c_ids, shard), lr)
    upd_out, gsq_out = _adagrad_rows(g_out, _take(p.acc_out, out_ids, shard), lr)
    _add_rows(p.emb_in, c_ids, upd_c, shard)
    _add_rows(p.emb_out, out_ids, upd_out, shard)
    _add_rows(p.acc_in, c_ids, gsq_c, shard)
    _add_rows(p.acc_out, out_ids, gsq_out, shard)


def _sample_center_block(words, pos_info, keep_prob, k: int, d):
    """C centers x k dynamic-window contexts over the flat corpus ->
    (c_safe [C], x_safe [C*k], valid [C*k])."""
    N = words.shape[0]
    flat = d["flat"]
    info = pos_info[flat]
    pos = info >> 16
    slen = info & 0xFFFF
    center = words[flat]
    # gensim's reduced window: b ~ U{1..window} per center, offsets U{+-1..b}
    off = d["off"] % d["b"][:, None] + 1
    sign = torch.where(d["sign"], 1, -1)
    ctx_pos = pos[:, None] + sign * off
    in_bounds = (ctx_pos >= 0) & (ctx_pos < slen[:, None])
    base = flat - pos
    ctx_idx = base[:, None] + torch.minimum(ctx_pos.clamp(min=0),
                                            (slen - 1).clamp(min=0)[:, None])
    context = words[ctx_idx.reshape(-1).clamp(0, N - 1)]

    su = d["keep"]
    c_safe = center.clamp(min=0)
    x_safe = context.clamp(min=0)
    keep_c = su[:, 0] < keep_prob[c_safe]
    keep_x = su[:, 1:].reshape(-1) < keep_prob[x_safe]
    valid = (in_bounds.reshape(-1) & keep_c.repeat_interleave(k) & keep_x
             & (center.repeat_interleave(k) >= 0) & (context >= 0))
    return c_safe, x_safe, valid


def _block_neg_grads(c, pv, negs_rows, valid, n_negs: int):
    """Center-block SGNS gradients: c [C, D] center rows, pv [C, k, D]
    context rows, negs_rows [Nc, Ks, D] the negative pool of each chunk of
    C/Nc centers, valid [C, k]. A center's negative terms weigh by its
    valid pair count times n_negs / Ks. -> (g_c [C, D], g_pv [C, k, D],
    g_n [Nc, Ks, D], loss sum, valid pairs (at least 1))."""
    C, k, D = pv.shape
    Nc, Ks, _ = negs_rows.shape
    vf = valid.to(torch.float32)
    pos_logit = torch.bmm(pv, c[:, :, None])[..., 0]                 # [C, k]
    d_pos = (torch.sigmoid(pos_logit) - 1.0) * vf
    g_pv = d_pos[:, :, None] * c[:, None, :]
    cc = c.reshape(Nc, C // Nc, D)
    neg_logit = torch.bmm(cc, negs_rows.transpose(1, 2))             # [Nc, Bc, Ks]
    w_center = vf.sum(dim=1).reshape(Nc, -1) * (n_negs / Ks)
    d_neg = torch.sigmoid(neg_logit) * w_center[:, :, None]
    g_c = (d_pos[:, :, None] * pv).sum(dim=1) + torch.bmm(d_neg, negs_rows).reshape(C, D)
    g_n = torch.bmm(d_neg.transpose(1, 2), cc)                       # [Nc, Ks, D]
    per_center_neg = -F.logsigmoid(-neg_logit).sum(dim=2).reshape(C) * w_center.reshape(C)
    loss = torch.sum(-F.logsigmoid(pos_logit) * vf) + torch.sum(per_center_neg)
    return g_c, g_pv, g_n, loss, valid.sum().clamp(min=1)


def _block_step(p: SGNSParams, words, pos_info, neg_prob, neg_alias, keep_prob,
                lr: float, k: int, n_negs: int, d, optimizer: str = "adagrad") -> torch.Tensor:
    """One block step (otto_tpu's _sgns_step_body_block), in place on p:
    per-row Adagrad, or with optimizer "sgd" the plain step -lr * g, the
    accumulators left alone. -> the loss per valid pair."""
    c_safe, x_safe, valid = _sample_center_block(words, pos_info, keep_prob, k, d)
    C = c_safe.shape[0]
    D = p.emb_in.shape[1]
    Ks = n_negs * _SHARED_NEG_FACTOR
    j = d["neg_j"]
    negs = torch.where(d["neg_u"] < neg_prob[j], j, neg_alias[j])
    Nc = negs.shape[0] // Ks
    ids_out = torch.cat([x_safe, negs])
    rows_out = p.emb_out[ids_out]
    c = p.emb_in[c_safe]
    g_c, g_pv, g_n, loss, n_valid = _block_neg_grads(
        c, rows_out[: C * k].reshape(C, k, D), rows_out[C * k:].reshape(Nc, Ks, D),
        valid.reshape(C, k), n_negs)
    g_out = torch.cat([g_pv.reshape(C * k, D), g_n.reshape(-1, D)])
    if optimizer == "sgd":
        _add_rows_unbounded(p.emb_in, c_safe, -lr * g_c)
        _add_rows_unbounded(p.emb_out, ids_out, -lr * g_out)
    else:
        _sparse_adagrad(p, c_safe, g_c, ids_out, g_out, lr)
    return loss / n_valid


def _sample_pair_batch(words, cum_len, keep_prob, d):
    """B (center, context) pairs over the flat corpus, positions drawn in
    proportion to session length -> (c_safe, x_safe, valid) [B]."""
    N = words.shape[0]
    S = cum_len.shape[0] - 1
    total = cum_len[-1]
    flat = torch.minimum((d["pos_u"] * total.to(torch.float32)).to(torch.int64), total - 1)
    sess = (torch.searchsorted(cum_len, flat, right=True) - 1).clamp(0, S - 1)
    base = cum_len[sess]
    pos = flat - base
    sess_len = cum_len[sess + 1] - base
    off = d["off"] % d["b"] + 1
    sign = torch.where(d["sign"], 1, -1)
    ctx_pos = pos + sign * off
    in_bounds = (ctx_pos >= 0) & (ctx_pos < sess_len)
    ctx_idx = base + torch.minimum(ctx_pos.clamp(min=0), (sess_len - 1).clamp(min=0))
    center = words[flat.clamp(0, N - 1)]
    context = words[ctx_idx.clamp(0, N - 1)]
    valid = in_bounds & (center >= 0) & (context >= 0)
    su = d["keep"]
    c_safe = center.clamp(min=0)
    x_safe = context.clamp(min=0)
    valid &= (su[:, 0] < keep_prob[c_safe]) & (su[:, 1] < keep_prob[x_safe])
    return c_safe, x_safe, valid


def _chunk_neg_grads(c, rows_out, valid, batch: int, n_negs: int):
    """Chunk-shared-negative SGNS gradients: c [B, D] center rows, rows_out
    [B + Nc*Ks, D] context rows ++ the chunks' negative pools.
    -> (g_c [B, D], g_out [B + Nc*Ks, D], loss sum, valid pairs)."""
    Bc = min(_NEG_CHUNK, batch)
    Nc = max(1, batch // Bc)
    Ks = n_negs * _SHARED_NEG_FACTOR
    D = c.shape[-1]
    vf = valid.to(torch.float32)
    pv = rows_out[:batch]
    pos_logit = torch.sum(c * pv, dim=-1)
    d_pos = (torch.sigmoid(pos_logit) - 1.0) * vf
    n = rows_out[batch:].reshape(Nc, Ks, D)
    cc = c.reshape(Nc, Bc, D)
    neg_logit = torch.bmm(cc, n.transpose(1, 2))                     # [Nc, Bc, Ks]
    neg_w = n_negs / Ks
    d_neg = torch.sigmoid(neg_logit) * (vf.reshape(Nc, Bc)[:, :, None] * neg_w)
    g_c = d_pos[:, None] * pv + torch.bmm(d_neg, n).reshape(-1, D)
    g_n = torch.bmm(d_neg.transpose(1, 2), cc)
    g_out = torch.cat([d_pos[:, None] * c, g_n.reshape(-1, D)])
    per_pair = -F.logsigmoid(pos_logit) - neg_w * F.logsigmoid(-neg_logit).sum(dim=-1).reshape(-1)
    loss = torch.sum(torch.where(valid, per_pair, 0.0))
    return g_c, g_out, loss, valid.sum().clamp(min=1)


def _dense_step(p: SGNSParams, c_ids, x_ids, negs, valid, lr: float) -> torch.Tensor:
    """Per-pair negatives with whole-table gradients and whole-table
    Adagrad (the accumulators first, then the scaled step), in place on p.
    Gradients are written by hand: d/dz -log s(z) = s(z) - 1 and
    d/dz -log s(-z) = s(z). -> the loss sum over valid pairs."""
    c = p.emb_in[c_ids]
    pv = p.emb_out[x_ids]
    n = p.emb_out[negs]                                              # [B, K, D]
    vf = valid.to(torch.float32)
    pos_logit = torch.sum(c * pv, dim=-1)
    neg_logit = torch.bmm(n, c[:, :, None])[..., 0]                 # [B, K]
    d_pos = (torch.sigmoid(pos_logit) - 1.0) * vf
    d_neg = torch.sigmoid(neg_logit) * vf[:, None]
    g_in = _row_sums(c_ids, d_pos[:, None] * pv + torch.bmm(d_neg[:, None, :], n)[:, 0],
                     p.emb_in.shape)
    g_out = _row_sums(
        torch.cat([x_ids, negs.reshape(-1)]),
        torch.cat([d_pos[:, None] * c, (d_neg[:, :, None] * c[:, None, :]).reshape(-1, c.shape[1])]),
        p.emb_out.shape)
    p.acc_in.add_(torch.mean(g_in ** 2, dim=1))
    p.acc_out.add_(torch.mean(g_out ** 2, dim=1))
    p.emb_in.sub_((lr * torch.rsqrt(p.acc_in + 1e-8))[:, None] * g_in)
    p.emb_out.sub_((lr * torch.rsqrt(p.acc_out + 1e-8))[:, None] * g_out)
    per_pair = -F.logsigmoid(pos_logit) - F.logsigmoid(-neg_logit).sum(dim=-1)
    return torch.sum(torch.where(valid, per_pair, 0.0))


def _pair_step(p: SGNSParams, words, cum_len, neg_cdf, keep_prob, lr: float,
               batch: int, n_negs: int, d, neg_mode: str,
               shard: Optional[TableShard] = None) -> torch.Tensor:
    """One pair- or chunk-mode step (otto_tpu's _sgns_step_body; on a
    shard, chunk mode only: _sgns_step_body_mp), in place on p. -> the loss
    per valid pair."""
    c_safe, x_safe, valid = _sample_pair_batch(words, cum_len, keep_prob, d)
    if neg_mode == "chunk":
        negs = torch.searchsorted(neg_cdf, d["neg_u"].reshape(-1))
        ids_out = torch.cat([x_safe, negs])
        g_c, g_out, loss, n_valid = _chunk_neg_grads(
            _take(p.emb_in, c_safe, shard), _take(p.emb_out, ids_out, shard), valid,
            batch, n_negs)
        _sparse_adagrad(p, c_safe, g_c, ids_out, g_out, lr, shard)
        return loss / n_valid
    negs = torch.searchsorted(neg_cdf, d["neg_u"])
    loss = _dense_step(p, c_safe, x_safe, negs, valid, lr)
    return loss / valid.sum().clamp(min=1)


def fuse_params(p: SGNSParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """SGNSParams -> (tab_in, tab_out), [V, D+1] each: a table's rows with
    its accumulator as the last column."""
    return (torch.cat([p.emb_in, p.acc_in[:, None]], 1),
            torch.cat([p.emb_out, p.acc_out[:, None]], 1))


def unfuse_params(tab_in: torch.Tensor, tab_out: torch.Tensor) -> SGNSParams:
    """fuse_params' inverse, as contiguous copies."""
    D = tab_in.shape[1] - 1
    return SGNSParams(tab_in[:, :D].contiguous(), tab_out[:, :D].contiguous(),
                      tab_in[:, D].contiguous(), tab_out[:, D].contiguous())


def _fused_chunk_step(tab_in: torch.Tensor, tab_out: torch.Tensor, words, cum_len, neg_cdf,
                      keep_prob, lr: float, batch: int, n_negs: int, d) -> torch.Tensor:
    """One chunk step on fused tables (otto_tpu's _sgns_step_body_chunk_fused),
    in place: one row gather and one row scatter a table, the same sums
    as _pair_step's chunk step and so its tables bit for bit. -> the loss
    per valid pair."""
    D = tab_in.shape[1] - 1
    c_safe, x_safe, valid = _sample_pair_batch(words, cum_len, keep_prob, d)
    ids_out = torch.cat([x_safe, torch.searchsorted(neg_cdf, d["neg_u"].reshape(-1))])
    c_f, out_f = tab_in[c_safe], tab_out[ids_out]                    # [B | M, D+1]
    g_c, g_out, loss, n_valid = _chunk_neg_grads(
        c_f[:, :D].contiguous(), out_f[:, :D].contiguous(), valid, batch, n_negs)
    _add_fused_rows(tab_in, c_safe, *_adagrad_rows(g_c, c_f[:, D], lr), c_f)
    _add_fused_rows(tab_out, ids_out, *_adagrad_rows(g_out, out_f[:, D], lr), out_f)
    return loss / n_valid


def sgd_rate(cfg: Word2VecConfig, epoch: int, step: int, n_steps: int) -> float:
    """The plain-SGD rate of `step` of `epoch` (absolute, so a resumed run
    goes on down the same line), otto_tpu's: constant over each dispatch
    of steps_per_dispatch steps, sgd_alpha -> sgd_min_alpha linearly by
    the dispatch's index among all of the run's, taken in float64 and
    rounded to float32. n_steps: an epoch's steps (whole dispatches)."""
    chunk = max(1, cfg.steps_per_dispatch)
    n_chunks = n_steps // chunk
    done = epoch * n_chunks + step // chunk
    total = max(1, cfg.epochs * n_chunks)
    a0, a1 = float(cfg.sgd_alpha), float(cfg.sgd_min_alpha)
    return float(np.float32(a0 + (a1 - a0) * (done / total)))


def sgns_step(p: SGNSParams, center: torch.Tensor, pos: torch.Tensor,
              neg_cdf: torch.Tensor, lr: float, d) -> torch.Tensor:
    """One host-sampler step on a [B] batch of (center, context) pairs,
    negatives by CDF search of d["neg_u"] [B, K], in place on p.
    -> the mean loss per pair."""
    negs = torch.searchsorted(neg_cdf, d["neg_u"])
    valid = torch.ones(center.shape, dtype=torch.bool, device=center.device)
    return _dense_step(p, center.long(), pos.long(), negs, valid, lr) / center.shape[0]


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------
def _state(p: SGNSParams, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    return {**p._asdict(), "generator": gen.get_state()}


def train_word2vec_device(
    ev: Events,
    cfg: Word2VecConfig,
    n_aids: Optional[int] = None,
    device="cuda",
    checkpoint_path: Optional[str] = None,
    draws: Optional[Draws] = None,
    start: Optional[np.ndarray] = None,
    mesh_ctx=None,
) -> Word2Vec:
    """Device-sampled SGNS training, as otto_tpu's train_word2vec_device:
    the flat corpus on `device`, ceil(positions * window /
    batch_size / steps_per_dispatch) * steps_per_dispatch steps per epoch
    at the constant Adagrad lr (block steps with optimizer "sgd": plain
    SGD at sgd_rate), the step kind from negative_mode and block_k
    (OTTO_W2V_BLOCK=0 turns the block sampler off; OTTO_W2V_FUSED=1 takes
    fused chunk steps in its place, on one device with chunk negatives).

    Resumes from `checkpoint_path` when it holds a checkpoint of this
    model (name, V, vector_size, epochs, seed, window, negatives); with
    OTTO_W2V_CKPT_EVERY=N saves one every N epochs but the last. A
    checkpoint holds the unfused tables whatever the step kind, so a
    fused run resumes from an unfused one's and the other way round.
    `draws(epoch, step)` replaces the default draws (block_draws /
    pair_draws from a torch.Generator on `device`); `start` replaces
    init_params' random table. -> Word2Vec with its TrainReport.

    With `mesh_ctx` and a model axis > 1 (every rank calling with the same
    events), the tables split over the model ranks (TableShard) and the
    steps are chunk steps with the per-pair sampler, as otto_tpu's
    model-parallel training forces them; no checkpoint is kept. Every rank
    returns the whole model."""
    dev = resolve(device)
    vocab = build_vocab(ev, cfg.types, cfg.min_count, n_aids)
    if vocab.size == 0:
        raise ValueError("empty vocabulary")
    V = vocab.size
    words_np, cum = flat_corpus(ev, vocab, cfg.types)
    positions = int(cum[-1])
    if positions == 0:
        raise ValueError("no session with two words of the vocabulary")
    steps_per_epoch = max(1, positions * cfg.window // cfg.batch_size)
    chunk = max(1, cfg.steps_per_dispatch)
    n_steps = -(-steps_per_epoch // chunk) * chunk
    neg_mode = negative_mode(cfg, V, positions)
    n_model = 1 if mesh_ctx is None else mesh_ctx.n_model
    if n_model > 1:
        if neg_mode != "chunk":
            log.info("w2v[device] %s: model-parallel steps are chunk steps, not %s",
                     cfg.name, neg_mode)
        neg_mode = "chunk"
        checkpoint_path = None
    fused = (neg_mode == "chunk" and n_model == 1
             and os.environ.get("OTTO_W2V_FUSED", "0") == "1")
    block = (neg_mode == "chunk" and cfg.block_k > 1 and n_model == 1 and not fused
             and os.environ.get("OTTO_W2V_BLOCK", "1") != "0")
    mode = "block" if block else "fused" if fused else neg_mode
    optimizer = cfg.optimizer if block else "adagrad"
    if optimizer != cfg.optimizer:
        log.info("w2v[device] %s: optimizer %s applies to block steps only; %s steps "
                 "train with adagrad", cfg.name, cfg.optimizer, mode)
    log.info("w2v[device] %s: %s steps, %s (V=%d, positions=%d)", cfg.name, mode,
             optimizer, V, positions)

    params = init_params(V, cfg.vector_size, cfg.seed, dev, start)
    gen = torch.Generator(device=dev).manual_seed(_seed32(cfg.seed * 1_000_003 + 1))
    meta = {"name": cfg.name, "V": V, "vector_size": cfg.vector_size,
            "epochs": cfg.epochs, "seed": cfg.seed, "window": cfg.window,
            "negatives": cfg.negatives}
    start_epoch = 0
    if checkpoint_path is not None:
        restored = load_checkpoint(checkpoint_path, _state(params, gen), expect_meta=meta)
        if restored is not None:
            state, start_epoch = restored
            gen.set_state(state.pop("generator"))
            params = SGNSParams(**state)
            log.info("w2v[device] %s resumed at epoch %d", cfg.name, start_epoch)

    shard = None
    if n_model > 1:
        params, shard = _shard_params(params, n_model, mesh_ctx)
    words = torch.from_numpy(words_np).to(dev).long()
    keep_prob = torch.from_numpy(keep_probs(vocab.counts, cfg.subsample_t)).to(dev)
    lr = cfg.learning_rate
    Ks = cfg.negatives * _SHARED_NEG_FACTOR
    if block:
        k = cfg.block_k
        cpc = max(1, _NEG_CHUNK // k)           # centers per negative chunk
        n_centers = -(-max(1, cfg.batch_size // k) // cpc) * cpc
        n_pool = max(1, n_centers // cpc) * Ks
        prob, alias = make_alias(vocab.counts, cfg.ns_exponent)
        prob = torch.from_numpy(prob).to(dev)
        alias = torch.from_numpy(alias).to(dev).long()
        pos_info = torch.from_numpy(pack_position_info(cum)).to(dev).long()
        pairs_per_step = n_centers * k

        def sample(g):
            return block_draws(g, n_centers, k, cfg.window, positions, V, n_pool)

        def step(epoch, i, d):
            rate = sgd_rate(cfg, epoch, i, n_steps) if optimizer == "sgd" else lr
            return _block_step(params, words, pos_info, prob, alias, keep_prob, rate,
                               k, cfg.negatives, d, optimizer)
    else:
        B = cfg.batch_size
        neg_shape = ((max(1, B // min(_NEG_CHUNK, B)), Ks) if neg_mode == "chunk"
                     else (B, cfg.negatives))
        cum_d = torch.from_numpy(cum).to(dev).long()
        neg_cdf = torch.from_numpy(make_neg_cdf(vocab.counts, cfg.ns_exponent)).to(dev)
        pairs_per_step = B

        def sample(g):
            return pair_draws(g, B, cfg.window, neg_shape)

        if fused:
            tables = fuse_params(params)
            params = None

            def step(epoch, i, d):
                return _fused_chunk_step(*tables, words, cum_d, neg_cdf, keep_prob, lr, B,
                                         cfg.negatives, d)
        else:
            def step(epoch, i, d):
                return _pair_step(params, words, cum_d, neg_cdf, keep_prob, lr, B,
                                  cfg.negatives, d, neg_mode, shard)

    def saved_state():
        return _state(unfuse_params(*tables) if fused else params, gen)

    if draws is None:
        def draws(epoch, i):
            return sample(gen)

    ckpt_every = int(os.environ.get("OTTO_W2V_CKPT_EVERY", "0") or 0)
    losses = []
    loop_s = 0.0
    for epoch in range(start_epoch, cfg.epochs):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        total = torch.zeros((), device=dev)
        for i in range(n_steps):
            total += step(epoch, i, draws(epoch, i))
        losses.append(float(total) / n_steps)
        loop_s += time.perf_counter() - t0
        log.info("w2v[device] %s epoch %d: %d steps, mean loss %.4f", cfg.name, epoch,
                 n_steps, losses[-1])
        if (checkpoint_path is not None and ckpt_every > 0
                and (epoch + 1) % ckpt_every == 0 and epoch + 1 < cfg.epochs):
            save_checkpoint(checkpoint_path, saved_state(), epoch + 1, meta=meta)

    report = TrainReport(mode, V, positions, n_steps, len(losses), pairs_per_step, losses,
                         optimizer, loop_s)
    emb = tables[0][:, :cfg.vector_size].contiguous() if fused else params.emb_in
    if shard is not None:
        emb = gather_equal(emb[:shard.vs], shard.group, n_model)[:V]
    return Word2Vec(cfg, vocab, emb.cpu().numpy(), report)


def _shard_params(p: SGNSParams, n_model: int, mesh_ctx) -> Tuple[SGNSParams, TableShard]:
    """This model rank's rows of every table (rows padded to a multiple of
    n_model, accumulators with 1e-6) plus the scratch row."""
    V = p.emb_in.shape[0]
    vs = -(-V // n_model)
    v0 = mesh_ctx.model_rank * vs

    def rows(x, fill):
        pad = x.new_full((vs * n_model + 1 - V,) + x.shape[1:], fill)
        return torch.cat([x, pad])[v0:v0 + vs + 1].clone()

    return (SGNSParams(rows(p.emb_in, 0.0), rows(p.emb_out, 0.0), rows(p.acc_in, 1e-6),
                       rows(p.acc_out, 1e-6)),
            TableShard(v0, vs, mesh_ctx.model_group))


def train_word2vec(
    ev: Events,
    cfg: Word2VecConfig,
    n_aids: Optional[int] = None,
    device="cuda",
    draws: Optional[Draws] = None,
    start: Optional[np.ndarray] = None,
) -> Word2Vec:
    """Host-sampled SGNS training, as otto_tpu's train_word2vec: per epoch
    numpy pairs (skipgram_pairs, rng seeded with cfg.seed), in steps of
    batch_size (the last padded with pair (0, 0)), lr falling linearly
    from learning_rate to min_learning_rate over the run. `draws` /
    `start` as for train_word2vec_device (host_draws by default)."""
    dev = resolve(device)
    rng = np.random.default_rng(cfg.seed)
    vocab = build_vocab(ev, cfg.types, cfg.min_count, n_aids)
    if vocab.size == 0:
        raise ValueError("empty vocabulary")
    B = cfg.batch_size
    params = init_params(vocab.size, cfg.vector_size, cfg.seed, dev, start)
    neg_cdf = torch.from_numpy(make_neg_cdf(vocab.counts, cfg.ns_exponent)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(_seed32(cfg.seed * 1_000_003 + 1))
    if draws is None:
        def draws(epoch, i):
            return host_draws(gen, B, cfg.negatives)

    losses = []
    for epoch in range(cfg.epochs):
        c, x = skipgram_pairs(ev, vocab, cfg.types, cfg.window, cfg.subsample_t, rng)
        n_pairs = len(c)
        n_steps = max(1, n_pairs // B)
        pad = max(0, B - n_pairs)
        c = torch.from_numpy(np.concatenate([c, np.zeros(pad, np.int32)])).to(dev)
        x = torch.from_numpy(np.concatenate([x, np.zeros(pad, np.int32)])).to(dev)
        total = torch.zeros((), device=dev)
        for i in range(n_steps):
            frac = (epoch + i / n_steps) / cfg.epochs
            lr = cfg.learning_rate + (cfg.min_learning_rate - cfg.learning_rate) * frac
            sl = slice(i * B, (i + 1) * B)
            total += sgns_step(params, c[sl], x[sl], neg_cdf, lr, draws(epoch, i))
        losses.append(float(total) / n_steps)
        log.info("w2v %s epoch %d: %d pairs, mean loss %.4f", cfg.name, epoch,
                 n_pairs, losses[-1])
    report = TrainReport("host", vocab.size, n_pairs, n_steps, cfg.epochs, B, losses)
    return Word2Vec(cfg, vocab, params.emb_in.cpu().numpy(), report)
