#!/usr/bin/env python3
"""chip_smoke.py's phase 9 (the multi-device paths) at a small size.

    python3 scripts/smoke_multi_device.py [--device cpu|cuda]

Builds a work dir as phases 4, 4b and 5 do (4,000 generated sessions,
3,000 aids, 16-d one-epoch word2vec models, 25-tree rankers), then runs
phase 9 on it: (a) one rank (NCCL on the card, gloo on the CPU) and (b)
two ranks over gloo, every stage held to the unsharded outputs. On the
CPU the card's memory readings are stubbed and no kernel launch is
required (the kernels' plain twins run there); phase 9's batch runner is
held to the batch runner run here in one process (phase 7's part). Then
the tool on two ranks: `python -m otto_tpu_torch.pipeline.cli
run-synthetic --tiny`, with `--streaming` and without (the batch runner),
in one process and under `torch.distributed.run --nproc-per-node 2` with
`--mesh data=2` (on the card the two ranks share it, over gloo): the
whole sharded Pipeline (build from nothing, pass A or the batch runner's
downsampling, dp GBDT training, serving), its artifacts byte-equal to the
one-process run's (the rankers array by array) and its metrics equal: the
ranks draw one device's negatives and bags. ~4 min on the CPU.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from otto_tpu_torch import config  # noqa: E402

DEVICE = sys.argv[sys.argv.index("--device") + 1] if "--device" in sys.argv else "cuda"
# module level: the spawned ranks import this file too and see the same
# sizes and stubs
cs.N_AIDS = 3000
cs.BATCH = 256
for _n, _w in list(config.W2VEC_MODELS.items()):
    config.W2VEC_MODELS[_n] = dataclasses.replace(_w, epochs=1, batch_size=8192,
                                                  vector_size=16, knn_first_n_aids=2000)
if DEVICE == "cpu":
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0


def main():
    from otto_tpu_torch.config import TYPES, Config, RankerConfig
    from otto_tpu_torch.data.split import split_events
    from otto_tpu_torch.data.synthetic import SyntheticSpec, generate
    from otto_tpu_torch.device import pin_fp32
    from otto_tpu_torch.eval.recall import evaluate_topk
    from otto_tpu_torch.pipeline.runner import (
        Pipeline,
        load_downsampled,
        pass_a,
        score_pass,
        train_ranker_cached,
    )

    pin_fp32()
    t0 = time.time()
    sp = split_events(generate(SyntheticSpec(n_sessions=4000, n_aids=cs.N_AIDS, max_len=64,
                                             mean_len=10, seed=5)), test_days=7, seed=0)
    cfg = Config(gbdt=dataclasses.replace(Config().gbdt, n_trees=cs.MESH_GBDT_TREES))
    with tempfile.TemporaryDirectory() as work:
        pipe = Pipeline(cfg, work, cs.N_AIDS, device=DEVICE)
        retriever = pipe.build_retriever(sp.train, sp.test)
        dev = pipe.device
        pass_a(retriever, sp.test, sp.labels, RankerConfig(), work, batch_sessions=cs.BATCH)
        rankers = {t: train_ranker_cached(work, t, lambda t=t: load_downsampled(work, t),
                                          cfg, dev, use_cache=False) for t in TYPES}
        preds = score_pass(retriever, sp.test, rankers, cs.BATCH)
        recall = evaluate_topk(preds, sp.labels)
        ctx = retriever.ctx
        pop = tuple(t.cpu().numpy() for t in (ctx.pop_cl50_cand, ctx.pop_cl50_ranks,
                                              ctx.pop_cl1_rank))
        del retriever, ctx
        batch = Pipeline(cfg, work, cs.N_AIDS, device=DEVICE)
        metrics = batch.run(sp.train, sp.test, sp.labels, batch_sessions=cs.BATCH)
        batch_ref = cs.keep_batch_outputs(work, metrics, cs.batch_steps(batch.stage_log))
        del batch
        print(f"# work dir built in {time.time() - t0:.1f} s", flush=True)
        smi = DEVICE if DEVICE == "cpu" else cs.phase_device()
        cs.phase_multi_device(smi, sp, work, pop, preds, recall, {}, batch_ref, device=DEVICE)
    tool_on_two_ranks()
    print(f"# done in {time.time() - t0:.1f} s")
    return 0


# the work-dir files a one-process run and a run on ranks write alike,
# byte for byte; the rankers' .npz files hold their write times and are
# compared array by array
TOOL_ARTIFACTS = ("covis.pkl", "w2v-", "knn-", "session_emb.npz", "clusters.npz",
                  "eval_retrieved", "passA-metrics.json", "config.json", "meta.json",
                  "submission.csv", "eval_submission.json", "feat-importance-")


def tool_on_two_ranks():
    """run-synthetic --tiny, streaming and batch runner, in one process and
    on two ranks (--mesh data=2 under torch.distributed.run), on DEVICE:
    the same artifacts and rankers, the same metrics."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    args = ["-m", "otto_tpu_torch.pipeline.cli", "run-synthetic", "--tiny", "--device", DEVICE,
            "--sessions", "4000", "--aids", "3000", "--batch-sessions", "256"]
    for runner in ("--streaming", "--no-streaming"):
        with tempfile.TemporaryDirectory() as tmp:
            runs = {}
            for tag, launch in (("one", []), ("two", ["-m", "torch.distributed.run",
                                                      "--standalone", "--nproc-per-node", "2"])):
                work = os.path.join(tmp, tag)
                t0 = time.time()
                out = subprocess.run([sys.executable] + launch + args + [runner]
                                     + (["--mesh", "data=2"] if launch else [])
                                     + ["--work-dir", work],
                                     capture_output=True, text=True, env=env, timeout=600)
                cs.require(out.returncode == 0, f"the tool ({tag}, {runner}): exit "
                           f"{out.returncode}\n" + out.stderr[-4000:])
                runs[tag] = json.loads(out.stdout)
                print(f"# the tool {runner}, {tag} rank(s): {time.time() - t0:.1f} s with "
                      f"start-up, metrics {runs[tag]}", flush=True)
            cs.require(runs["one"] == runs["two"], f"the tool {runner} on two ranks: metrics "
                       "equal to one process's")
            cs.require(runs["two"]["total"] > 0.2, "the tool on two ranks: recall@20 > 0.2")
            one, two = os.path.join(tmp, "one"), os.path.join(tmp, "two")
            names = sorted(n for n in os.listdir(one) if n.startswith(TOOL_ARTIFACTS))
            cs.require(len(names) >= 14, f"the tool's artifacts: {names}")
            for name in names:
                with open(os.path.join(one, name), "rb") as fa, \
                        open(os.path.join(two, name), "rb") as fb:
                    cs.require(fa.read() == fb.read(),
                               f"the tool {runner} on two ranks: {name} byte-equal")
            for name in (n for n in os.listdir(one) if n.startswith("ranker-gbdt-")):
                za, zb = np.load(os.path.join(one, name)), np.load(os.path.join(two, name))
                cs.require(all(za[k].tobytes() == zb[k].tobytes() for k in za.files),
                           f"the tool {runner} on two ranks: {name} equal array by array")
        print(f"# the tool {runner} on two ranks (--mesh data=2): artifacts and rankers "
              "equal to one process's, metrics equal")


if __name__ == "__main__":
    sys.exit(main())
