"""The benchmark's harness: finds a cell's files by the names in
BENCHMARK.json, runs its traffic's driver once, and prints the result
line.

Layout (each piece found by name, so a later cell, configuration,
traffic mix or metric is a new file and a new entry):
- `benchmark/configs/<config>.json`: a configuration (BENCHMARK.json names
  its file);
- `benchmark/traffic/<traffic>.json`: a traffic mix; its "driver" names
  the module `benchmark/<driver>.py` that runs it: `run(cfg, traffic,
  seed, seconds, trace, device, t_start)` -> {correct, attempted, failed,
  end_to_end: {metric: value}, memory_peak_bytes, checks, info, and with
  trace the probe's summary};
- `benchmark/metrics/<metric>.py`: the reader of a per-layer metric, or,
  for a name `<reader>.<suffix>`, the reader `<reader>.py` shared by its
  suffixes; each declares LAYER, UNIT and MOVES and returns None where it
  finds nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level modules that no run may load (the JAX package and JAX itself)
FORBIDDEN = ("jax", "jaxlib", "flax", "otto_tpu")


class SetupError(RuntimeError):
    """The run cannot start here: no card, too few cards, or files missing."""


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def find_cell(spec: dict, workload: str, root: Path = ROOT):
    """-> (cell, config dict, traffic dict) of the named workload."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SetupError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    with open(root / configs[cell["config"]]["file"]) as fh:
        cfg = json.load(fh)
    with open(BENCH / "traffic" / f"{cell['traffic']}.json") as fh:
        traffic = json.load(fh)
    return cell, cfg, traffic


def metrics_of(spec: dict, workload: str, kind: str):
    """The end_to_end or per_layer entries that the cell reports."""
    return [m for m in spec[kind] if "workloads" not in m or workload in m["workloads"]]


def reader_path(name: str) -> Optional[Path]:
    """metrics/<name>.py, else the reader of the longest dotted prefix."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        p = BENCH / "metrics" / (".".join(parts[:n]) + ".py")
        if p.exists():
            return p
    return None


def load_reader(name: str):
    path = reader_path(name)
    if path is None:
        raise SetupError(f"no reader for metric {name!r} under benchmark/metrics/")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (otto_tpu_torch is not otto_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(chips: int, cuda: bool) -> dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def require_devices(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise SetupError("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise SetupError(f"the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} are visible")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", root: Path = ROOT, spec: Optional[dict] = None,
             cfg: Optional[dict] = None, traffic: Optional[dict] = None,
             log=print) -> Dict:
    """Run one cell once -> the result line as a dict. `cfg` / `traffic`
    replace the cell's files (tests run a tiny copy); device "cpu" runs
    the kernels' plain twins and reports the CPU."""
    spec = spec if spec is not None else load_spec(root)
    cell, cfg0, traffic0 = find_cell(spec, workload, root)
    cfg = cfg if cfg is not None else cfg0
    traffic = traffic if traffic is not None else traffic0
    cuda = device != "cpu"
    if cuda:
        require_devices(cell["chips"])
    if not (root / "otto_tpu_torch").is_dir():
        raise SetupError("otto_tpu_torch/ is not beside benchmark/: nothing to measure")
    driver = importlib.import_module(f"benchmark.{traffic['driver']}")
    res = driver.run(cfg, traffic, seed, seconds, trace, device, t_start)

    metrics = {}
    if trace:
        summary = res.get("summary") or {}
        for m in metrics_of(spec, workload, "per_layer"):
            v = load_reader(m["name"]).read(summary)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in metrics_of(spec, workload, "end_to_end"):
            v = res["end_to_end"].get(m["name"])
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = device_info(cell["chips"], cuda)
    dev["memory_peak_bytes"] = res["memory_peak_bytes"]
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": dev}
    if trace:
        summary = res.get("summary") or {}
        if summary.get("busy_s"):
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary.get("device_ops", [])[:10],
                            "idle_gaps": summary.get("idle_gaps", [])[:10]}
    out["checks"] = res["checks"]
    log(json.dumps({"info": res.get("info", {})}))
    return out
