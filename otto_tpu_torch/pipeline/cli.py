"""Command-line interface of the port: `otto-tpu-torch` or
`python -m otto_tpu_torch.pipeline.cli`.

Counterpart of otto_tpu/pipeline/cli.py, with its commands: `synth`,
`ingest`, `split`, `run`, `rank` and `run-synthetic`. The commands that run
the pipeline take `--device` (default `cuda`: without a card they fail,
they never fall back to the CPU; `--device cpu` runs there). Stage
artifacts and their reuse live in otto_tpu_torch.pipeline.runner.
`run` and `run-synthetic` take `--ranker-backend` (runner.RANKER_BACKENDS);
`rank` serves with the backend of the work dir's config.json.
`synth`, `ingest`, `split`, `run` and `rank` read or write parquet, which
needs pyarrow; `run-synthetic` needs nothing but the port.

`--mesh data=N,model=M` runs the pipeline's mesh branches on N x M ranks,
one process each, started by torchrun:

  python -m torch.distributed.run --nproc-per-node 4 \
      -m otto_tpu_torch.pipeline.cli run-synthetic --tiny --device cpu --mesh data=4

Rank 0 writes the work dir and prints the metrics.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

import numpy as np
import torch.distributed as dist

from otto_tpu_torch.config import (
    DEFAULT,
    Config,
    CoVisConfig,
    GBDTConfig,
    KMeansConfig,
    RankerConfig,
    RetrievalConfig,
    Word2VecConfig,
    config_from_json,
    setup_logging,
)
from otto_tpu_torch.data.schema import Events, Labels
from otto_tpu_torch.data.split import split_events
from otto_tpu_torch.data.synthetic import SyntheticSpec, generate
from otto_tpu_torch.pipeline.runner import RANKER_BACKENDS, Pipeline, run_synthetic

log = logging.getLogger(__name__)


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--work-dir", default="artifacts", help="artifact directory")
    p.add_argument("--no-cache", action="store_true", help="recompute all stages")
    p.add_argument("--device", default="cuda",
                   help="torch device of the pipeline: cuda (default), cuda:N or cpu")
    p.add_argument("--mesh", default=None, metavar="data=N,model=M",
                   help="rank mesh: every stage sharded over N x M ranks (data, model), "
                        "one process each under torchrun --nproc-per-node N*M; "
                        "data=-1 means every rank the model axis leaves")


def parse_mesh_spec(spec):
    """'data=N,model=M' -> {'data_parallel': N, 'model_parallel': M}.
    Either axis may be omitted (model defaults to 1, data to -1 = rest)."""
    if not spec:
        return None
    out = {"data_parallel": -1, "model_parallel": 1}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad --mesh component {part!r}; want axis=N")
        k, v = part.split("=", 1)
        k = k.strip()
        if k not in ("data", "model"):
            raise ValueError(f"unknown mesh axis {k!r} (want data/model)")
        out[f"{k}_parallel"] = int(v)
    return out


def build_mesh(args):
    """--mesh -> MeshContext, or None when unset or 1x1 (the unsharded
    path). Starts this rank from torchrun's environment (init_distributed
    on --device) and lays the mesh over every rank; a world size other
    than data x model raises, naming both."""
    kw = parse_mesh_spec(getattr(args, "mesh", None))
    if kw is None:
        return None
    from otto_tpu_torch.parallel.distributed import global_mesh, init_distributed
    from otto_tpu_torch.parallel.mesh import make_mesh

    dev = init_distributed(args.device)
    world = dist.get_world_size() if dev is not None else 1
    data, model = kw["data_parallel"], kw["model_parallel"]
    want = data * model if data != -1 else model
    if (data != -1 and want != world) or world % model:
        raise ValueError(
            f"--mesh {args.mesh} wants {want} ranks but the world size is {world}; "
            f"run it under python -m torch.distributed.run --nproc-per-node {want}")
    if world == 1:
        log.info("--mesh resolved to a single device; running unsharded")
        return None
    ctx = (global_mesh(model, device=dev) if data == -1
           else make_mesh(data, model, device=dev))
    log.info("mesh: %d ranks (data=%d, model=%d), rank %d on %s", ctx.n_devices,
             ctx.n_data, ctx.n_model, dist.get_rank(), ctx.device)
    return ctx


def _emit(metrics) -> None:
    """Print the metrics JSON (rank 0 only under a mesh)."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(metrics, indent=2))


def _with_backend(cfg: Config, args) -> Config:
    """cfg with --ranker-backend, when given."""
    if args.ranker_backend is None:
        return cfg
    return dataclasses.replace(cfg, ranker_backend=args.ranker_backend)


def _use_streaming(args, test: Events) -> bool:
    return args.streaming or (not args.no_streaming
                              and len(np.unique(test.session)) > 50_000)


def cmd_synth(args) -> int:
    """Generate a synthetic OTTO-like dataset to parquet."""
    ev = generate(SyntheticSpec(n_sessions=args.sessions, n_aids=args.aids, seed=args.seed))
    ev.to_parquet(args.out)
    log.info("wrote %d events to %s", len(ev), args.out)
    return 0


def cmd_ingest(args) -> int:
    """OTTO-format JSONL -> columnar parquet (C6; native C++ parser)."""
    from otto_tpu_torch.data.jsonl import load_labels_jsonl, load_sessions_jsonl

    ev = load_sessions_jsonl(args.sessions_jsonl)
    ev.to_parquet(args.out_prefix + "-events.parquet")
    log.info("ingested %d events from %s", len(ev), args.sessions_jsonl)
    if args.labels_jsonl:
        lab = load_labels_jsonl(args.labels_jsonl)
        lab.to_parquet(args.out_prefix + "-labels.parquet")
        log.info("ingested %d labels from %s", len(lab), args.labels_jsonl)
    return 0


def cmd_split(args) -> int:
    """Carve the last-N-days local test split with labels (C5)."""
    sp = split_events(Events.from_parquet(args.events), test_days=args.days, seed=args.seed)
    sp.train.to_parquet(args.out_prefix + "-train.parquet")
    sp.test.to_parquet(args.out_prefix + "-test.parquet")
    sp.labels.to_parquet(args.out_prefix + "-labels.parquet")
    log.info("split: train=%d test=%d labels=%d", len(sp.train), len(sp.test), len(sp.labels))
    return 0


def _pipeline(args, cfg: Config, train: Events, test: Events) -> Pipeline:
    """A Pipeline over --work-dir for these events: n_aids as the work
    dir's meta.json stores it (a run on generated data keeps the
    generator's), else the largest aid + 1."""
    mesh = build_mesh(args)
    n_aids = int(max(train.aid.max(), test.aid.max())) + 1
    mpath = os.path.join(args.work_dir, "meta.json")
    if not args.no_cache and os.path.exists(mpath):
        with open(mpath) as fh:
            n_aids = max(n_aids, json.load(fh).get("n_aids", 0))
    return Pipeline(cfg=cfg, work_dir=args.work_dir, n_aids=n_aids,
                    use_cache=not args.no_cache, device=args.device, mesh=mesh)


def cmd_run(args) -> int:
    """Full pipeline on parquet inputs (count -> embed -> retrieve -> rank
    -> submit -> eval)."""
    train, test = Events.from_parquet(args.train), Events.from_parquet(args.test)
    labels = Labels.from_parquet(args.labels) if args.labels else None
    pipe = _pipeline(args, _with_backend(DEFAULT, args), train, test)
    runner = pipe.run_streaming if _use_streaming(args, test) else pipe.run
    _emit(runner(train, test, labels, batch_sessions=args.batch_sessions))
    return 0


def cmd_rank(args) -> int:
    """Inference only: score an unlabelled test set with the rankers a
    labelled run trained in the same work dir, and write submission.csv."""
    train, test = Events.from_parquet(args.train), Events.from_parquet(args.test)
    # the configuration the work dir's artifacts were built with
    cpath = os.path.join(args.work_dir, "config.json")
    cfg = config_from_json(cpath) if os.path.exists(cpath) else DEFAULT
    pipe = _pipeline(args, cfg, train, test)
    runner = pipe.run_streaming if _use_streaming(args, test) else pipe.run
    runner(train, test, None, batch_sessions=args.batch_sessions)
    log.info("wrote %s", pipe._p("submission.csv"))
    return 0


def tiny_config() -> Config:
    """otto_tpu's small configuration for CPU demos and smoke runs (the
    fields the port has)."""
    w2v = dict(
        wall=Word2VecConfig(name="wall", types=(0, 1, 2), vector_size=16, window=4,
                            min_count=2, epochs=2, batch_size=4096, knn_k=10,
                            knn_first_n_aids=5000),
        w12=Word2VecConfig(name="w12", types=(1, 2), vector_size=16, window=4,
                           min_count=2, epochs=1, batch_size=4096, knn_k=10,
                           knn_first_n_aids=5000),
    )
    return Config(
        covis=dataclasses.replace(CoVisConfig(), accumulator_capacity=1 << 17),
        retrieval=RetrievalConfig(max_session_aids=16, max_candidates=128,
                                  session_len_buckets=(8, 32)),
        w2vec=w2v,
        kmeans=dataclasses.replace(KMeansConfig(), max_iter=10),
        ranker=RankerConfig(hidden_dims=(32, 16), epochs=3, batch_sessions=64,
                            max_group=64, learning_rate=3e-3),
        gbdt=GBDTConfig(n_trees=20, max_depth=3, n_bins=16, colsample=0.5,
                        subsample=0.8, min_child_samples=5, max_group=64,
                        row_chunk=4096, group_chunk=256),
    )


def cmd_run_synthetic(args) -> int:
    """Full pipeline on generated data (demo / smoke)."""
    mesh = build_mesh(args)
    spec = SyntheticSpec(n_sessions=args.sessions, n_aids=args.aids, seed=args.seed)
    streaming = True if args.streaming else (None if not args.no_streaming else False)
    cfg = _with_backend(tiny_config() if args.tiny else DEFAULT, args)
    metrics = run_synthetic(cfg, args.work_dir, spec,
                            batch_sessions=args.batch_sessions, streaming=streaming,
                            device=args.device, mesh=mesh)
    _emit(metrics)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="otto-tpu-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("synth", help=cmd_synth.__doc__)
    p.add_argument("--sessions", type=int, default=100_000)
    p.add_argument("--aids", type=int, default=50_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("ingest", help=cmd_ingest.__doc__)
    p.add_argument("--sessions-jsonl", required=True)
    p.add_argument("--labels-jsonl")
    p.add_argument("--out-prefix", required=True)
    p.set_defaults(fn=cmd_ingest)

    p = sub.add_parser("split", help=cmd_split.__doc__)
    p.add_argument("--events", required=True)
    p.add_argument("--days", type=int, default=7)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out-prefix", required=True)
    p.set_defaults(fn=cmd_split)

    streaming_help = ("two-pass streaming runner (one batch's features on the "
                      "device; auto past 50k test sessions)")
    backend_help = "the rankers' model class (default: the config's, gbdt)"
    p = sub.add_parser("run", help=cmd_run.__doc__)
    p.add_argument("--train", required=True)
    p.add_argument("--test", required=True)
    p.add_argument("--labels")
    p.add_argument("--batch-sessions", type=int, default=256)
    p.add_argument("--streaming", action="store_true", help=streaming_help)
    p.add_argument("--no-streaming", action="store_true", help="force the batch runner")
    p.add_argument("--ranker-backend", choices=list(RANKER_BACKENDS), help=backend_help)
    _add_common(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("rank", help=cmd_rank.__doc__)
    p.add_argument("--train", required=True)
    p.add_argument("--test", required=True)
    p.add_argument("--batch-sessions", type=int, default=256)
    p.add_argument("--streaming", action="store_true", help=streaming_help)
    p.add_argument("--no-streaming", action="store_true", help="force the batch runner")
    _add_common(p)
    p.set_defaults(fn=cmd_rank)

    p = sub.add_parser("run-synthetic", help=cmd_run_synthetic.__doc__)
    p.add_argument("--sessions", type=int, default=20_000)
    p.add_argument("--aids", type=int, default=5_000)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--batch-sessions", type=int, default=256)
    p.add_argument("--tiny", action="store_true", help="small-model config (fast demo)")
    p.add_argument("--streaming", action="store_true", help=streaming_help)
    p.add_argument("--no-streaming", action="store_true", help="force the batch runner")
    p.add_argument("--ranker-backend", choices=list(RANKER_BACKENDS), help=backend_help)
    _add_common(p)
    p.set_defaults(fn=cmd_run_synthetic)

    args = parser.parse_args(argv)
    setup_logging(getattr(args, "work_dir", None))
    try:
        return args.fn(args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
