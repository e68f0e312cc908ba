#!/usr/bin/env python3
"""Where an SGNS block step spends its time on the card.

    python3 scripts/probe_sgns_torch.py [--sessions 500000] [--device cuda]

Generates chip_smoke.py's events (1.8M aids, sessions up to 512 events),
builds w2v-all's vocabulary and flat corpus at W2VEC_MODELS defaults
(100-d, window 10, 8 negatives, 65,536 pairs a step in centers of
block_k = 4), then runs one epoch of block steps split into phases,
each timed with CUDA events around it: sampling (the step's draws, the
center block and the alias negatives), row gathers (the center, context
and negative rows and their accumulators), gradients (logits, pair and
pool gradients, Adagrad scales) and the four deterministic row updates
(`_add_rows`: index_put_ with accumulate on the card). The phases mirror
models/word2vec.py's _block_step, checked bit-equal to it on one step
first. Then the same
number of steps through _block_step itself, without the events, and the
peak memory. Prints the card's name and power limit beside the numbers.
`--device cpu` runs the same at a small --sessions as a rehearsal (its
times are the CPU's, not the card's).
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from otto_tpu_torch.config import W2VEC_MODELS  # noqa: E402
from otto_tpu_torch.data.split import split_events  # noqa: E402
from otto_tpu_torch.data.synthetic import SyntheticSpec, generate  # noqa: E402
from otto_tpu_torch.device import pin_fp32, resolve  # noqa: E402
from otto_tpu_torch.models import word2vec as w2v  # noqa: E402

N_AIDS = 1_800_000
PHASES = ("sampling", "row gathers", "gradients", "row updates: emb_in",
          "row updates: emb_out", "row updates: acc_in", "row updates: acc_out")


class Marks:
    """Time stamps between phases: CUDA events on the card, the host clock
    on the CPU (whose ops finish before they return)."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.steps = []

    def step(self):
        self.steps.append([])

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.steps[-1].append(e)
        else:
            self.steps[-1].append(time.perf_counter())

    def ms(self):
        """-> per phase, the milliseconds summed over the steps."""
        if self.cuda:
            torch.cuda.synchronize()
        tot = [0.0] * (len(self.steps[0]) - 1)
        for s in self.steps:
            for i in range(len(tot)):
                tot[i] += (s[i].elapsed_time(s[i + 1]) if self.cuda
                           else (s[i + 1] - s[i]) * 1e3)
        return tot


def timed_block_step(p, words, pos_info, prob, alias, keep_prob, lr, k, n_negs,
                     sample, marks):
    """_block_step in timed phases (same operations, same order)."""
    marks.mark()
    d = sample()
    c_safe, x_safe, valid = w2v._sample_center_block(words, pos_info, keep_prob, k, d)
    j = d["neg_j"]
    negs = torch.where(d["neg_u"] < prob[j], j, alias[j])
    marks.mark()
    C, D = c_safe.shape[0], p.emb_in.shape[1]
    Ks = n_negs * w2v._SHARED_NEG_FACTOR
    ids_out = torch.cat([x_safe, negs])
    rows_out = p.emb_out[ids_out]
    c = p.emb_in[c_safe]
    acc_c = p.acc_in[c_safe]
    acc_out = p.acc_out[ids_out]
    marks.mark()
    g_c, g_pv, g_n, loss, n_valid = w2v._block_neg_grads(
        c, rows_out[: C * k].reshape(C, k, D),
        rows_out[C * k:].reshape(negs.shape[0] // Ks, Ks, D), valid.reshape(C, k), n_negs)
    g_out = torch.cat([g_pv.reshape(C * k, D), g_n.reshape(-1, D)])
    gsq_c = torch.mean(g_c ** 2, dim=1)
    gsq_out = torch.mean(g_out ** 2, dim=1)
    scale_c = lr * torch.rsqrt(acc_c + gsq_c + 1e-8)
    scale_out = lr * torch.rsqrt(acc_out + gsq_out + 1e-8)
    upd_c = -scale_c[:, None] * g_c
    upd_out = -scale_out[:, None] * g_out
    for table, ids, rows in ((p.emb_in, c_safe, upd_c), (p.emb_out, ids_out, upd_out),
                             (p.acc_in, c_safe, gsq_c), (p.acc_out, ids_out, gsq_out)):
        marks.mark()
        w2v._add_rows(table, ids, rows)
    marks.mark()
    return loss / n_valid


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=500_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve(args.device)
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    else:
        smi = "CPU"

        def sync():
            return None

        torch.cuda.synchronize = torch.cuda.reset_peak_memory_stats = sync
        torch.cuda.max_memory_allocated = lambda *a: 0
    pin_fp32()
    cfg = dataclasses.replace(W2VEC_MODELS["w2v-all"], neg_sharing="chunk")
    spec = SyntheticSpec(n_sessions=args.sessions, n_aids=N_AIDS, max_len=512,
                         mean_len=18, seed=1234)
    sp = split_events(generate(spec, dev), test_days=7, seed=0)
    full = sp.train.concat(sp.test)
    t = time.perf_counter()
    vocab = w2v.build_vocab(full, cfg.types, cfg.min_count, N_AIDS)
    words_np, cum = w2v.flat_corpus(full, vocab, cfg.types)
    prob, alias = w2v.make_alias(vocab.counts, cfg.ns_exponent)
    pos_info = w2v.pack_position_info(cum)
    keep = w2v.keep_probs(vocab.counts, cfg.subsample_t)
    host_s = time.perf_counter() - t
    V, positions = vocab.size, int(cum[-1])
    k, n_negs = cfg.block_k, cfg.negatives
    cpc = w2v._NEG_CHUNK // k
    C = -(-(cfg.batch_size // k) // cpc) * cpc
    n_pool = C // cpc * n_negs * w2v._SHARED_NEG_FACTOR
    chunk = cfg.steps_per_dispatch
    n_steps = -(-max(1, positions * cfg.window // cfg.batch_size) // chunk) * chunk
    print(f"# {len(full)} events, V = {V} words, {positions} corpus positions, "
          f"{n_steps} steps an epoch of {C} centers x k = {k} "
          f"({C * k} pairs, {C * k + n_pool} emb_out rows); host preparation "
          f"{host_s:.2f} s (vocabulary, corpus, alias tables, position map)")

    def put(x, long=False):
        x = torch.from_numpy(x).to(dev)
        return x.long() if long else x

    words, pos_info, prob, alias, keep = (put(words_np, True), put(pos_info, True),
                                          put(prob), put(alias, True), put(keep))
    gen = torch.Generator(device=dev).manual_seed(1)

    def sample():
        return w2v.block_draws(gen, C, k, cfg.window, positions, V, n_pool)

    # the mirror against _block_step: one step from the same state and draws
    p = w2v.init_params(V, cfg.vector_size, cfg.seed, dev)
    q = w2v.SGNSParams(*(x.clone() for x in p))
    state = gen.get_state()
    marks = Marks(dev)
    marks.step()
    timed_block_step(p, words, pos_info, prob, alias, keep, cfg.learning_rate, k, n_negs,
                     sample, marks)
    gen.set_state(state)
    w2v._block_step(q, words, pos_info, prob, alias, keep, cfg.learning_rate, k, n_negs,
                    sample())
    same = all(torch.equal(a, b) for a, b in zip(p, q))
    print(f"# timed phases == _block_step on one step: {same}")
    if not same:
        raise SystemExit("the timed mirror differs from _block_step")

    marks = Marks(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(n_steps):
        marks.step()
        timed_block_step(p, words, pos_info, prob, alias, keep, cfg.learning_rate, k,
                         n_negs, sample, marks)
    phase_ms = marks.ms()
    timed_s = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n_steps):
        w2v._block_step(q, words, pos_info, prob, alias, keep, cfg.learning_rate, k,
                        n_negs, sample())
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    total = sum(phase_ms)
    print(f"# one epoch of {n_steps} block steps ({smi}):")
    for name, ms in zip(PHASES, phase_ms):
        print(f"#   {name}: {ms / n_steps:.3f} ms/step ({100 * ms / total:.1f}%)")
    print(f"#   phases summed {total / n_steps:.3f} ms/step; wall {timed_s:.2f} s with the "
          f"events, {plain_s:.2f} s through _block_step = {n_steps / plain_s:.1f} steps/s, "
          f"{n_steps * C * k / plain_s / 1e6:.2f}M pairs/s; peak "
          f"{peak / 2**30:.2f} GiB allocated")


if __name__ == "__main__":
    main()
