#!/usr/bin/env python3
"""Fault 1 (ROADMAP Queue 3) with the CPU's worker threads tied to cores.

    python3 scripts/probe_fault1_pinned.py [--processes 8] [--parallel 2]
        [--deadline 1500] [--places cores] [--out-dir DIR]

Runs `scripts/repeat_cross_check.py --history --runs 3` in fresh
processes, `--parallel` at a time, each with OMP_PROC_BIND=true and
OMP_PLACES=`--places` (default "cores": worker i of the CPU pool stays
on core i for the whole process; "{1},{2},...,{7},{0}" puts the calling
thread, worker 0, on core 1 and worker 7 on core 0), and starts no
process past `--deadline` seconds. Each process
gives itself chip_smoke.py's history (kernels, table build, pass A,
25-tree rankers, a score_pass) and then three seeded retrieval
cross-checks; the first one's two CPU runs and card run keep their
eucl_dist_ses_aid roots (repeat_cross_check.KeepTail). Writes every
process's output to DIR/proc{i}.log (default _local/fault1) and prints, per
process, whether the first CPU run came out wrong, in which session rows,
and the lines that compare its roots with the second run's and the
card's; then one JSON line with the counts and the card's name and power
limit. Needs a CUDA device.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=8)
    ap.add_argument("--parallel", type=int, default=2)
    ap.add_argument("--deadline", type=float, default=1500.0)
    ap.add_argument("--places", default="cores", help="OMP_PLACES of every process")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "_local", "fault1"),
                    help="where each process's log goes")
    args = ap.parse_args()
    out_dir = args.out_dir
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, OMP_PROC_BIND="true", OMP_PLACES=args.places, PYTHONUNBUFFERED="1")
    cmd = [sys.executable, os.path.join(ROOT, "scripts", "repeat_cross_check.py"),
           "--history", "--runs", "3"]
    t0 = time.perf_counter()
    running, done, started = {}, {}, 0
    while started < args.processes or running:
        while (started < args.processes and len(running) < args.parallel
               and time.perf_counter() - t0 < args.deadline):
            log = open(os.path.join(out_dir, f"proc{started}.log"), "w")
            running[started] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                                 env=env, cwd=ROOT), log)
            started += 1
        if started < args.processes and time.perf_counter() - t0 >= args.deadline:
            args.processes = started     # no new process past the deadline
        for i, (p, log) in list(running.items()):
            if p.poll() is not None:
                log.close()
                done[i] = p.returncode
                del running[i]
        time.sleep(2)
    summary = {"processes": len(done), "places": args.places, "wrong_first_runs": 0,
               "failed": [], "rows": {},
               "card": None, "seconds": round(time.perf_counter() - t0, 1)}
    for i in sorted(done):
        with open(os.path.join(out_dir, f"proc{i}.log")) as fh:
            text = fh.read()
        lines = [ln for ln in text.splitlines() if ln.startswith("# tail sqrt")
                 or "fault 1 recurred" in ln]
        result = [ln for ln in text.splitlines() if ln.startswith('{"runs"')]
        if done[i] != 0 or not result:
            summary["failed"].append(i)
            print(f"# process {i}: exit {done[i]}; last lines: {text.splitlines()[-5:]}")
            continue
        res = json.loads(result[-1])
        summary["card"] = res["card"]
        rows = sorted({int(r) for ln in lines if "(rows " in ln
                       for r in re.findall(r"\d+", ln.split("(rows ")[1].split(")")[0])})
        print(f"# process {i}: {res['failures']} of {res['runs']} checks failed "
              f"{res['seeds_failed']}; the first check's CPU roots wrong in rows {rows}")
        for ln in lines:
            print(f"#   {ln[:600]}")
        if rows:
            summary["wrong_first_runs"] += 1
            summary["rows"][i] = rows
    print(json.dumps(summary))
    return 1 if summary["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
