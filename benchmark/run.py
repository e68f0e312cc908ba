"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), device, with --trace 1 a breakdown, and last the
numbers compared for `correct`, each beside its limit (also the last
lines of standard error). Exits non-zero, printing no result, without
the CUDA devices the cell asks for, without the program beside the
benchmark, or when the JAX package or JAX was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the run inside the checkout, at fixed paths: the port
    # builds its kernels into otto_tpu_torch/build/; a Triton kernel or a
    # torch extension that a later version of it adds caches here
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import harness

    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               T_START, log=lambda *a: print(*a, file=sys.stderr))
    except harness.SetupError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}; no module of JAX or of the JAX "
              "package may be loaded", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
