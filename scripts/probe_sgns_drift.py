#!/usr/bin/env python3
"""How far float32 rounding alone moves an SGNS training, against how far
the port's training lies from otto_tpu's, step by step.

    JAX_PLATFORMS=cpu python scripts/probe_sgns_drift.py [--pairs 512 1024]

The case is tests/test_mesh_stages.py::test_sgns_model_parallel_matches_single's:
400 generated sessions of 300 aids, 16-d vectors, window 4, chunk-shared
negatives with the per-pair sampler, lr 0.25, one epoch, from otto_tpu's
start table and threefry draws. Three trainings step side by side from
that start and those draws:

  ref32   otto_tpu's step (`_sgns_step_body`, jitted), float32;
  port32  the port's step (`_pair_step`), float32;
  port64  the port's step on float64 tables (the same sums in float64:
          the run float32 rounding would give if it did not round).

Per step it prints the largest |difference| of the input tables and the
largest excess over the tests' tolerance (|a - b| - (2e-5 + 2e-4 |b|),
positive where assert_allclose(rtol=2e-4, atol=2e-5) fails) for each
pair of runs, and the local error: one port step against one otto_tpu
step from otto_tpu's state. A last line compares the stepped ref32 with
otto_tpu's own train_word2vec_device (its fused dispatches). CPU only;
~1 min.
"""
import argparse
import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from otto_tpu.config import Word2VecConfig as RefConfig  # noqa: E402
from otto_tpu.data.synthetic import SyntheticSpec, generate  # noqa: E402
from otto_tpu.models import word2vec as ref  # noqa: E402
from otto_tpu_torch.data.schema import Events  # noqa: E402
from otto_tpu_torch.models import word2vec as port  # noqa: E402

CFG = dict(name="t", types=(0, 1, 2), vector_size=16, window=4, min_count=1, epochs=1,
           steps_per_dispatch=4, neg_sharing="chunk", knn_k=5, subsample_t=0, block_k=0)
RTOL, ATOL = 2e-4, 2e-5


def step_keys(seed: int, n_steps: int, chunk: int):
    """otto_tpu's key chain for epoch 0: split per epoch, fold_in per
    dispatch, fold_in per step."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    return [jax.random.fold_in(jax.random.fold_in(sub, s // chunk), s % chunk)
            for s in range(n_steps)]


def port_draws(key, B, window, neg_shape):
    """The draws of otto_tpu's _sample_pair_batch and chunk step from one
    step key, as the port's draws dict."""
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    r = jax.random
    d = {"pos_u": r.uniform(k1, (B,)), "b": r.randint(k2, (B,), 1, window + 1),
         "off": r.randint(k3, (B,), 1, window + 1), "sign": r.bernoulli(k4, 0.5, (B,)),
         "keep": r.uniform(k5, (B, 2)), "neg_u": r.uniform(k6, neg_shape)}
    out = {}
    for k, v in d.items():
        t = torch.from_numpy(np.array(v))
        out[k] = t.long() if not t.is_floating_point() and t.dtype != torch.bool else t
    return out


def excess(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) - (ATOL + RTOL * np.abs(b))))


def gap(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def run(pairs: int) -> None:
    cfg = RefConfig(**CFG, batch_size=pairs)
    ref_ev = generate(SyntheticSpec(n_sessions=400, n_aids=300, mean_len=8, seed=13))
    ev = Events(ref_ev.session, ref_ev.aid, ref_ev.ts, ref_ev.type)
    pcfg = port.Word2VecConfig(**CFG, batch_size=pairs)
    vocab = port.build_vocab(ev, pcfg.types, pcfg.min_count, None)
    words, cum = port.flat_corpus(ev, vocab, pcfg.types)
    positions = int(cum[-1])
    chunk = cfg.steps_per_dispatch
    n_steps = -(-max(1, positions * cfg.window // pairs) // chunk) * chunk
    B, n_negs, lr = pairs, cfg.negatives, cfg.learning_rate
    Ks = n_negs * port._SHARED_NEG_FACTOR
    neg_shape = (max(1, B // min(port._NEG_CHUNK, B)), Ks)
    keep = port.keep_probs(vocab.counts, cfg.subsample_t)
    cdf = port.make_neg_cdf(vocab.counts, cfg.ns_exponent)
    start = np.asarray(ref.init_params(vocab.size, cfg.vector_size, cfg.seed).emb_in)
    keys = step_keys(cfg.seed, n_steps, chunk)

    ref_step = jax.jit(ref._sgns_step_body, static_argnums=(6, 7, 8, 10))
    words_j, cum_j, cdf_j, keep_j = map(jnp.asarray, (words, cum, cdf, keep))
    V, D = start.shape
    r32 = ref.SGNSParams(jnp.asarray(start), jnp.zeros((V, D), jnp.float32),
                         jnp.full((V,), 1e-6, jnp.float32), jnp.full((V,), 1e-6, jnp.float32))

    def port_params(dtype):
        return port.SGNSParams(torch.tensor(start, dtype=dtype), torch.zeros((V, D), dtype=dtype),
                               torch.full((V,), 1e-6, dtype=dtype),
                               torch.full((V,), 1e-6, dtype=dtype))

    p32, p64 = port_params(torch.float32), port_params(torch.float64)
    words_t, cum_t = torch.from_numpy(words).long(), torch.from_numpy(cum).long()
    cdf_t, keep_t = torch.from_numpy(cdf), torch.from_numpy(keep)

    def port_step(p, d):
        port._pair_step(p, words_t, cum_t, cdf_t, keep_t, lr, B, n_negs, d, "chunk")

    print(f"# {pairs} pairs a step, {n_steps} steps, lr {lr}, V {V}, D {D} "
          f"(max |diff| of emb_in; excess over rtol {RTOL}, atol {ATOL})")
    print("step | ref32-port32 gap excess | port32-port64 gap excess | "
          "ref32-port64 gap excess | local step gap")
    for s, key in enumerate(keys):
        d = port_draws(key, B, cfg.window, neg_shape)
        # the local error: one port step from otto_tpu's current state
        local = port.SGNSParams(*(torch.from_numpy(np.array(x)) for x in r32))
        port_step(local, d)
        r32, _ = ref_step(r32, words_j, cum_j, cdf_j, keep_j, jnp.float32(lr), B,
                          cfg.window, n_negs, key, "chunk")
        port_step(p32, d)
        port_step(p64, d)
        a = np.asarray(r32.emb_in)
        b, c = p32.emb_in.numpy(), p64.emb_in.numpy()
        print(f"{s + 1:4d} | {gap(a, b):.3e} {excess(b, a):+.3e} | "
              f"{gap(b, c):.3e} {excess(b, c):+.3e} | {gap(a, c):.3e} {excess(a, c):+.3e} | "
              f"{gap(local.emb_in.numpy(), a):.3e}")
    full = ref.train_word2vec_device(ref_ev, cfg).emb
    print(f"# otto_tpu's train_word2vec_device against the stepped ref32: gap "
          f"{gap(full, np.asarray(r32.emb_in)):.3e}, excess "
          f"{excess(full, np.asarray(r32.emb_in)):+.3e}; against port64: gap "
          f"{gap(full, p64.emb_in.numpy()):.3e}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, nargs="+", default=[512, 1024])
    args = ap.parse_args()
    torch.set_num_threads(1)
    for pairs in args.pairs:
        run(pairs)


if __name__ == "__main__":
    main()
