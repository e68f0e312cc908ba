"""The port's reference-scale run: otto_tpu_torch's whole streaming
pipeline (Pipeline.run_streaming) on 12.9M synthetic sessions and 1.8M
aids at Config()'s full width, on one CUDA card, with each stage's
seconds, host RSS and peak device memory written to RUN_FULLSCALE_TORCH.json
as the stage ends. The counterpart of scripts/run_fullscale.py, with its
knobs, defaults and record schema.

The OTTO dataset is not in the repo, so the run generates events at the
reference's scale (README.md: 12.9M sessions, 1.8M aids, mean length
13.4): by default with data/synthetic.py's generate_device on the card,
with OTTO_FS_GEN=host with its numpy `generate`. The events are cached in
{work_dir}/events.npz, and the pipeline's own artifact cache (tables,
pass A's metrics and rows, rankers) lives in the same work dir, so a
rerun on it reads the same events and resumes after the last stage that
left its artifact.

With OTTO_FS_TMPFS=<dir> (a directory of this run's own in memory, for
example /dev/shm/otto_fs_12900k) the events cache and the seven table
artifacts (covis.pkl, w2v-*.npz, knn-*.npz,
session_emb.npz, clusters.npz) are written into that directory and the
work dir holds symbolic links to them; pass A's rows, the rankers, the
submission and the eval files stay in the work dir. The files and the
single work dir are as without the knob: every writer opens the link's
path, and a link whose file is not written yet does not count as cached.
The dir serves one work dir: a work dir with no link into it refuses a
dir that holds files, and cached events must fit the spec. Remove the
dir when the run and its resumes are done (~11 GiB of memory at 12.9M).
It keeps ~14 GB of writes off the disk at 12.9M sessions, for machines
that cap the bytes a run may write. Every stage's entry in the record
carries the bytes under the work dir on disk (`disk_bytes`, links not
followed), under the tmpfs dir (`tmpfs_bytes`) and the process's
`write_bytes` and `wchar` from /proc/self/io.

Usage:
  python scripts/run_fullscale_torch.py                      # 12.9M sessions
  OTTO_FS_SESSIONS=1290000 python scripts/run_fullscale_torch.py
  python scripts/run_fullscale_torch.py --report RUN_FULLSCALE_TORCH.json
  OTTO_FS_TMPFS=/dev/shm/otto_fs_12900k python scripts/run_fullscale_torch.py
  rm -rf /dev/shm/otto_fs_12900k
Knobs: OTTO_FS_SESSIONS / _AIDS / _MEANLEN / _MAXLEN / _WORKDIR (default
fullscale_work/ in the checkout) / _BATCH / _OUT / _GEN (device | host) /
_DEVSELECT (1: RankerConfig.device_select) / _WHY (why the scale was cut,
kept in the record's `reduced`) / _TMPFS (the tables' and events' dir).

`--report RECORD` renders a record as markdown: each stage's seconds, host
RSS and peak device memory, the stages beside the reference's CPU ETAs
(BASELINE.md 'Throughput'), the quality table beside the reference's
real-OTTO figures, and the per-source retrieval report.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from otto_tpu_torch.config import DEFAULT, Config  # noqa: E402
from otto_tpu_torch.data.schema import Events  # noqa: E402
from otto_tpu_torch.data.split import split_events  # noqa: E402
from otto_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticSpec,
    generate,
    generate_device,
)
from otto_tpu_torch.device import resolve  # noqa: E402
from otto_tpu_torch.eval.per_source import format_report  # noqa: E402
from otto_tpu_torch.pipeline.runner import Pipeline, host_rss_gb  # noqa: E402

log = logging.getLogger("fullscale_torch")

# the reference's stage ETAs in seconds at this data scale (BASELINE.md
# 'Throughput', self-logged on the reference's CPU box)
REFERENCE_ETA_S = {
    "covis": (20 + 30) * 60,          # count + merge stages
    "w2vec": 65 * 60,                 # all models
    "session_emb": 12 * 60,
    "kmeans": 24 * 60,
    "popularity": 10 * 60,
    "retrieve+downsample (pass A)": (40 + 5) * 60,
    "rankers": 10 * 60,
    "score (pass B)": 60 * 60,
    "eval_retrieved": 15 * 60,
}
# the reference's quality on the real OTTO data (README.md:42-47, BASELINE.md)
REFERENCE_QUALITY = {"ceiling_total": 0.637356, "total": 0.566174, "ratio": 0.888,
                     "cand_per_session": (172.4, 56, 2322)}
# seconds between two writes of the record while the pipeline runs
POLL_S = 30.0
# the scale the reference ran, against which `reduced` lists a cut
REFERENCE_SPEC = {"n_sessions": 12_900_000, "n_aids": 1_800_000, "mean_len": 13.4,
                  "max_len": 128}


def _command(args: List[str]) -> Optional[str]:
    """A command's standard output, or None where it cannot run."""
    try:
        return subprocess.run(args, capture_output=True, text=True, timeout=60,
                              check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def device_record(dev: torch.device) -> Dict[str, object]:
    """The device a run used: on CUDA its name and, as nvidia-smi reads
    them, name and power limit."""
    if dev.type != "cuda":
        return {"type": dev.type, "name": dev.type}
    return {"type": "cuda", "name": torch.cuda.get_device_name(dev),
            "nvidia_smi": _command(["nvidia-smi", "--query-gpu=name,power.limit",
                                    "--format=csv,noheader", f"--id={dev.index or 0}"])}


def reduced_from(spec: Dict[str, object], why: str) -> List[Dict[str, object]]:
    """Each knob of the spec that differs from the reference's scale."""
    return [{"knob": k, "value": spec[k], "reference": v, "why": why}
            for k, v in REFERENCE_SPEC.items() if spec[k] != v]


# what OTTO_FS_TMPFS moves off the disk: the events cache and the seven
# table artifacts ("{}": each word2vec model's name)
TMPFS_FILES = ("events.npz", "covis.pkl", "w2v-{}.npz", "knn-{}.npz", "session_emb.npz",
               "clusters.npz")


def tmpfs_names(cfg: Config) -> List[str]:
    """TMPFS_FILES with the models of cfg.w2vec filled in."""
    return [f.format(n) for f in TMPFS_FILES for n in (cfg.w2vec if "{}" in f else [None])]


def place_in_tmpfs(work_dir: str, tmpfs: str, names: List[str]) -> None:
    """Link work_dir/{name} to tmpfs/{name} for each name the work dir does
    not hold yet (a file a run without the knob wrote stays where it is).
    The tmpfs dir serves one work dir: a work dir that links nothing there
    yet refuses a dir that holds files, and no link is made to a file the
    work dir did not link (another run's events or tables would be read
    as this run's cache)."""
    tmpfs = os.path.abspath(tmpfs)
    links = {name: os.path.join(work_dir, name) for name in names}
    ours = [link for link in links.values() if os.path.islink(link)]
    for link in ours:
        if os.path.dirname(os.readlink(link)) != tmpfs:
            raise ValueError(f"{link} links {os.readlink(link)}, not a file in {tmpfs}")
    if not ours and os.path.isdir(tmpfs) and os.listdir(tmpfs):
        raise FileExistsError(f"{tmpfs} holds another run's files: remove it or name a "
                              "directory of this run's own")
    os.makedirs(tmpfs, exist_ok=True)
    for name, link in links.items():
        target = os.path.join(tmpfs, name)
        if os.path.lexists(link):
            continue
        if os.path.lexists(target):
            raise FileExistsError(f"{target} was not written through {link}")
        os.symlink(target, link)


def check_events(ev: Events, spec: SyntheticSpec) -> None:
    """Raise unless cached events fit `spec`: session ids 0..n_sessions-1
    (sorted, so the last is the largest) and item ids below n_aids."""
    got = (int(ev.session[-1]) + 1, int(ev.aid.max()) + 1)
    if got[0] != spec.n_sessions or got[1] > spec.n_aids:
        raise ValueError(f"cached events: {got[0]} sessions and aids up to {got[1]}, "
                         f"not {spec.n_sessions} sessions of {spec.n_aids} aids")


def dir_bytes(path: Optional[str]) -> Optional[int]:
    """Bytes of the regular files under `path`, links not followed."""
    if path is None:
        return None
    total = 0
    for d, _, files in os.walk(path):
        for f in files:
            f = os.path.join(d, f)
            if not os.path.islink(f):
                total += os.path.getsize(f)
    return total


def proc_io() -> Dict[str, Optional[int]]:
    """This process's `write_bytes` (bytes it caused to be written to a
    block device; tmpfs and file systems without one count nothing) and
    `wchar` (bytes handed to write calls, to any file) from /proc/self/io."""
    got: Dict[str, Optional[int]] = {"write_bytes": None, "wchar": None}
    try:
        with open("/proc/self/io") as fh:
            for line in fh:
                key, _, value = line.partition(":")
                if key in got:
                    got[key] = int(value)
    except OSError:
        pass
    return got


def io_record(work_dir: str, tmpfs: Optional[str]) -> Dict[str, Optional[int]]:
    return {"disk_bytes": dir_bytes(work_dir), "tmpfs_bytes": dir_bytes(tmpfs), **proc_io()}


@dataclasses.dataclass
class MeasuredPipeline(Pipeline):
    """A Pipeline whose stage_log entries also carry io_record(work_dir,
    tmpfs) as each stage ends."""

    tmpfs: Optional[str] = None

    def _log(self, stage: str, t0: float, msg: str = "",
             peak_bytes: Optional[int] = None) -> None:
        super()._log(stage, t0, msg, peak_bytes)
        self.stage_log[-1].update(io_record(self.work_dir, self.tmpfs))


def _peak_gb(dev: torch.device) -> Optional[float]:
    if dev.type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return round(peak / 2**30, 2)


def run(spec: SyntheticSpec, work_dir: str, out_path: str, batch: int = 2048,
        device="cuda", cfg: Config = DEFAULT, gen: str = "device",
        device_select: bool = True, why: str = "", tmpfs: Optional[str] = None) -> Dict:
    """Generate (or read from {work_dir}/events.npz) the events of `spec`,
    split them as cfg.data says and run Pipeline(cfg, work_dir, n_aids,
    device).run_streaming at `batch` sessions a batch, with
    RankerConfig.device_select as `device_select` says; with `tmpfs`, the
    events and tables are written there and linked from the work dir
    (place_in_tmpfs). The record is written to out_path (atomically) after
    generation and the split, every POLL_S seconds while the pipeline
    runs, and at its end. -> the record."""
    dev = resolve(device)
    os.makedirs(work_dir, exist_ok=True)
    if tmpfs is not None:
        place_in_tmpfs(work_dir, tmpfs, tmpfs_names(cfg))
    spec_rec = {"n_sessions": spec.n_sessions, "n_aids": spec.n_aids,
                "mean_len": spec.mean_len, "max_len": spec.max_len,
                "batch_sessions": batch}
    record = {
        "spec": spec_rec,
        "reference_eta_s": REFERENCE_ETA_S,
        "device": device_record(dev),
        "host": {"free_g": _command(["free", "-g"]),
                 "df_h": _command(["df", "-h", work_dir]),
                 "df_h_tmpfs": None if tmpfs is None else _command(["df", "-h", tmpfs])},
        "tmpfs": tmpfs,
        "reduced": reduced_from(spec_rec, why),
        "stages": [],
    }

    def flush():
        # atomic: a kill mid-write must not leave a truncated record
        tmp = out_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(record, fh, indent=2, default=float)
        os.replace(tmp, out_path)

    def fixed_stage(name, t):
        record["stages"].append({"stage": name, "elapsed_s": round(time.time() - t, 3),
                                 "rss_gb": round(host_rss_gb(), 2), "peak_mem_gb": _peak_gb(dev),
                                 **io_record(work_dir, tmpfs)})

    t0 = time.time()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # the events are cached: a rerun must read the very events the work
    # dir's artifacts were built from
    data_cache = os.path.join(work_dir, "events.npz")
    if os.path.exists(data_cache):
        z = np.load(data_cache)
        ev = Events(z["session"], z["aid"], z["ts"], z["type"])
        check_events(ev, spec)
        record["generator"] = "cache"
    elif gen == "device":
        ev = generate_device(spec, dev)
        record["generator"] = "device"
    elif gen == "host":
        ev = generate(spec)
        record["generator"] = "host"
    else:
        raise ValueError(f"OTTO_FS_GEN: 'device' or 'host', got {gen!r}")
    if record["generator"] != "cache":
        np.savez(data_cache, session=ev.session, aid=ev.aid, ts=ev.ts, type=ev.type)
    if dev.type == "cuda":
        torch.cuda.empty_cache()   # the walk's [S, L] grids are done with
    record["n_events"] = int(len(ev))
    fixed_stage("generate", t0)
    log.info("%s: %d events (%.1f a session)", record["generator"], len(ev),
             len(ev) / spec.n_sessions)
    flush()

    t1 = time.time()
    sp = split_events(ev, cfg.data.test_days, cfg.data.seed)
    del ev
    record["n_train_events"] = int(len(sp.train))
    record["n_test_sessions"] = int(len(np.unique(sp.test.session)))
    fixed_stage("split", t1)
    log.info("split: train=%d test_sessions=%d labels=%d", len(sp.train),
             record["n_test_sessions"], len(sp.labels.session))
    flush()

    if device_select:
        cfg = cfg.replace(ranker=dataclasses.replace(cfg.ranker, device_select=True))
    pipe = MeasuredPipeline(cfg=cfg, work_dir=work_dir, n_aids=spec.n_aids, device=dev,
                            tmpfs=tmpfs)
    t2 = time.time()
    n_fixed = len(record["stages"])
    lock = threading.Lock()

    def snapshot():
        # the stage log's elapsed seconds (since run_streaming began) -> deltas
        with lock:
            del record["stages"][n_fixed:]
            prev = 0.0
            for e in list(pipe.stage_log):
                d = dict(e)
                d["delta_s"] = round(d["elapsed_s"] - prev, 3)
                prev = d["elapsed_s"]
                record["stages"].append(d)
            record["pipeline_s_so_far"] = round(time.time() - t2, 3)
            flush()

    # a run of hours must leave its record if it is killed mid-stage
    stop = threading.Event()

    def poll():
        while not stop.wait(POLL_S):
            snapshot()

    poller = threading.Thread(target=poll, daemon=True, name="fullscale-poll")
    poller.start()
    try:
        metrics = pipe.run_streaming(sp.train, sp.test, sp.labels, batch_sessions=batch)
        record["metrics"] = {k: float(v) for k, v in metrics.items()}
    finally:
        stop.set()
        poller.join()   # no poll may race the last flush
        record["pipeline_s"] = round(time.time() - t2, 3)
        record["total_s"] = round(time.time() - t0, 3)
        per_source = os.path.join(work_dir, "eval_retrieved_sources.json")
        if os.path.exists(per_source):
            with open(per_source) as fh:
                record["per_source"] = json.load(fh)
        snapshot()
    log.info("done in %.1f s: %s", record["total_s"], json.dumps(record["metrics"]))
    return record


# ---------------------------------------------------------------------------
# --report
# ---------------------------------------------------------------------------
def reference_group(stage: str) -> Optional[str]:
    """The REFERENCE_ETA_S stage a pipeline stage's seconds count toward."""
    if stage.startswith("w2vec"):
        return "w2vec"
    if stage.startswith("ranker"):
        return "rankers"
    if stage.startswith("downsample") or stage.startswith("retrieve+downsample"):
        return "retrieve+downsample (pass A)"
    if stage.startswith("eval_retrieved") or stage == "eval per-source":
        return "eval_retrieved"
    return stage if stage in REFERENCE_ETA_S else None


def _num(x, fmt="{:.1f}") -> str:
    return "–" if x is None else fmt.format(x)


def report(rec: Dict) -> str:
    """The record as markdown: stages, stages against the reference's CPU
    ETAs, quality, per-source report."""
    dv = rec.get("device", {})
    card = dv.get("nvidia_smi") or dv.get("name", "?")
    sp = rec["spec"]
    cuts = "; ".join(f"{r['knob']} {r['value']} of the reference's {r['reference']}"
                     + (f" ({r['why']})" if r["why"] else "") for r in rec.get("reduced", []))
    out = [f"Port run on {card}: {sp['n_sessions']:,} sessions, {sp['n_aids']:,} aids, "
           f"mean length {sp['mean_len']}, batch {sp['batch_sessions']}; "
           f"{rec.get('n_events', 0):,} events, {rec.get('n_train_events', 0):,} train "
           f"events, {rec.get('n_test_sessions', 0):,} test sessions; generator "
           f"{rec.get('generator')}; reduced: {cuts or 'none'}.", "",
           "| Stage | s | host RSS GiB | peak device GiB |", "| --- | --- | --- | --- |"]
    groups: Dict[str, float] = {}
    other = 0.0
    for s in rec["stages"]:
        dt = s.get("delta_s", s["elapsed_s"])
        out.append(f"| {s['stage']} | {dt:.3f} | {_num(s.get('rss_gb'), '{:.2f}')} | "
                   f"{_num(s.get('peak_mem_gb'), '{:.2f}')} |")
        g = reference_group(s["stage"])
        if g is not None:
            groups[g] = groups.get(g, 0.0) + dt
        elif s["stage"] not in ("generate", "split"):
            other += dt
    out += ["", f"| Stage | reference (CPU box) | otto_tpu_torch ({card}) | reference / port |",
            "| --- | --- | --- | --- |"]
    tot_ref = tot_port = 0.0
    for g, ref_s in REFERENCE_ETA_S.items():
        if g not in groups:
            continue
        tot_ref += ref_s
        tot_port += groups[g]
        out.append(f"| {g} | {ref_s / 60:.0f} min | {groups[g] / 60:.2f} min | "
                   f"{ref_s / groups[g]:.1f}x |")
    out.append(f"| other (context, submit, eval) | – | {other / 60:.2f} min | – |")
    if tot_port + other > 0:
        out.append(f"| **pipeline** | **{tot_ref / 60:.0f} min** | "
                   f"**{(tot_port + other) / 60:.2f} min** | "
                   f"**{tot_ref / (tot_port + other):.1f}x** |")
    if "pipeline_s" in rec:
        out.append(f"| pipeline wall clock | – | {rec['pipeline_s'] / 60:.2f} min | – |")

    m = rec.get("metrics")
    if m:
        rq = REFERENCE_QUALITY
        out += ["", "| Quality | synthetic (this run) | reference (real OTTO) |",
                "| --- | --- | --- |"]
        for t in ("clicks", "carts", "orders"):
            out.append(f"| recall@20 {t}: ceiling / ranked | {m[f'ceiling_{t}']:.6f} / "
                       f"{m[t]:.6f} | – |")
        out.append(f"| retrieval ceiling recall@20 total | {m['ceiling_total']:.6f} | "
                   f"{rq['ceiling_total']} |")
        out.append(f"| ranked recall@20 total | {m['total']:.6f} | {rq['total']} |")
        if m["ceiling_total"]:
            out.append(f"| ranked / ceiling | {m['total'] / m['ceiling_total']:.3f} | "
                       f"~{rq['ratio']} |")
        c = rq["cand_per_session"]
        out.append(f"| candidates/session mean / min / max | "
                   f"{m['cand_per_session_mean']:.1f} / {m['cand_per_session_min']:.0f} / "
                   f"{m['cand_per_session_max']:.0f} | {c[0]} / {c[1]} / {c[2]} |")
    if rec.get("per_source"):
        out += ["", "Per-source retrieval recall (eval_retrieved_sources.json):", "",
                "```", format_report(rec["per_source"]), "```"]
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", metavar="RECORD", help="render a record as markdown")
    args = ap.parse_args(argv)
    if args.report:
        with open(args.report) as fh:
            print(report(json.load(fh)))
        return 0
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    env = os.environ
    spec = SyntheticSpec(n_sessions=int(env.get("OTTO_FS_SESSIONS", 12_900_000)),
                         n_aids=int(env.get("OTTO_FS_AIDS", 1_800_000)),
                         mean_len=float(env.get("OTTO_FS_MEANLEN", 13.4)),
                         max_len=int(env.get("OTTO_FS_MAXLEN", 128)),
                         span_days=28, seed=7)
    rec = run(spec, env.get("OTTO_FS_WORKDIR", os.path.join(ROOT, "fullscale_work")),
              env.get("OTTO_FS_OUT", "RUN_FULLSCALE_TORCH.json"),
              batch=int(env.get("OTTO_FS_BATCH", 2048)),
              gen=env.get("OTTO_FS_GEN", "device"),
              device_select=env.get("OTTO_FS_DEVSELECT", "1") == "1",
              why=env.get("OTTO_FS_WHY", ""), tmpfs=env.get("OTTO_FS_TMPFS") or None)
    print(json.dumps({"metrics": rec["metrics"], "total_s": rec["total_s"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
