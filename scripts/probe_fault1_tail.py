#!/usr/bin/env python3
"""Does PyTorch's CPU library alone reproduce fault 1 (ROADMAP Queue 3)?

    python3 scripts/probe_fault1_tail.py [--processes 8] [--parallel 2]
        [--history-seconds 150] [--loops 40]

Imports torch and the standard library only, nothing of the repository.
Each child process (--processes of them, --parallel at a time) first
gives the process a CUDA history like chip_smoke.py's phases 3 to 5 for
--history-seconds: large sorts, gathers and segment sums of int32
columns, int64 index_add_ updates, float32 matmuls with TF32 off, top-k,
and a worker thread that pulls each batch's results to the host on a
stream of its own and runs multi-threaded CPU sorts, gathers and float
math on them while the main thread launches the next batch.

Then, on the CPU, it runs the similarity block of one retrieval batch as
engine/retrieval.py computes eucl_dist_ses_aid, at its shape: session
embeddings [256, 100], candidate rows [256, 512, 100], the einsum dots,
the norms, then the elementwise tail `n_s**2 + n_c**2 - 2*dot`, the
clamp, the sqrt, the `where` and a stack of 104 feature columns; --loops
times, each with fresh seeded inputs, and each tail twice in a row as
chip_smoke.py's cross-check runs the CPU batch. A loop is faulty when
its two runs differ in a bit, when the tail lies more than TAIL_ULPS
float32 ulps from the same operations emulated in float64 from the same
float32 terms (every step rounded to float32), or when a term lies more
than 1e-5 relative from float64. The emulation rounds the square root
correctly; PyTorch's CPU sqrt need not (it is off by an ulp in ~0.6% of
values on an AVX512 host with torch 2.13), so up to TAIL_ULPS is normal,
and fault 1's error (~6e-5 relative, hundreds of ulps) is far beyond it.
A fault is printed with the 32-row shares of the batch it falls in (one
thread's share of 256 rows on 8 threads).

The parent prints one JSON line: processes, loops, mismatching loops and
whether any was the first loop after the history, torch's version, the
CPU capability, the threads and the card's name and power limit. Needs a
CUDA device.
"""
import argparse
import json
import os
import queue
import subprocess
import sys
import threading
import time

import torch

S, C, D, F = 256, 512, 100, 104
SHARE = 32
TAIL_ULPS = 4


def smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


# ---------------------------------------------------------------------------
# the CUDA history
# ---------------------------------------------------------------------------
def history(seconds, seed):
    """Card work of the kinds phases 3 to 5 run, with a consumer thread
    pulling each batch and working on it on the CPU. -> batches run."""
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((1_800_000, D), generator=g, device=dev)
    counts = torch.zeros(1 << 22, dtype=torch.int64, device=dev)
    work = queue.Queue(maxsize=1)
    stream = torch.cuda.Stream()
    errors = []

    def consume():
        try:
            while True:
                item = work.get()
                if item is None:
                    return
                ev, tensors = item
                with torch.cuda.stream(stream):
                    stream.wait_event(ev)
                    host = [t.to("cpu", non_blocking=True) for t in tensors]
                stream.synchronize()
                keys, top, emb = host
                order = torch.argsort(keys[:, :1024], dim=1, stable=True)
                picked = torch.gather(keys[:, :1024], 1, order)
                x = emb.reshape(-1, D)[:65536]
                _ = (torch.sqrt(torch.clamp((x * x).sum(1) - 2 * x[:, 0], min=0.0))
                     + picked.float().mean() + top.float().sum())
        except Exception as e:          # reported by the caller
            errors.append(e)

    worker = threading.Thread(target=consume, name="probe-consume")
    worker.start()
    t0, n = time.perf_counter(), 0
    try:
        while time.perf_counter() - t0 < seconds and not errors:
            keys = torch.randint(0, 1 << 20, (2048, 4096), generator=g, device=dev,
                                 dtype=torch.int32)
            vals, idx = torch.sort(keys, dim=1, stable=True)
            cols = torch.stack([keys, vals, idx.int()] * 8)           # [24, 2048, 4096]
            moved = torch.gather(cols, 2, idx.unsqueeze(0).expand_as(cols))
            seg = torch.cumsum(moved.long(), dim=2)
            counts.index_add_(0, (seg[0] & ((1 << 22) - 1)).reshape(-1),
                              torch.ones(seg[0].numel(), dtype=torch.int64, device=dev))
            ids = torch.randint(0, table.shape[0], (2048 * 512,), generator=g, device=dev)
            emb = table[ids].reshape(2048, 512, D)
            q = emb[:, 0]
            sims = torch.einsum("sd,scd->sc", q, emb)
            top = torch.topk(q @ table[:200_000].T, 20, dim=1).values
            _ = torch.linalg.norm(emb, dim=2) + sims
            ev = torch.cuda.Event()
            ev.record()
            work.put((ev, (keys, top, emb[:256])))
            n += 1
            del keys, vals, idx, cols, moved, seg, ids, emb, q, sims, top
    finally:
        work.put(None)
        worker.join(timeout=600)
    torch.cuda.synchronize()
    if errors:
        raise errors[0]
    return n


# ---------------------------------------------------------------------------
# the CPU tail of eucl_dist_ses_aid
# ---------------------------------------------------------------------------
def tail_f32(ses_emb, cand_vec, valid):
    """engine/retrieval.py's similarity block, float32 on the CPU. ->
    (dot, n_s, n_c, eucl feature, the stacked [S, C, F] features)."""
    dot = torch.einsum("sd,scd->sc", ses_emb, cand_vec)
    n_s = torch.linalg.norm(ses_emb, dim=1)[:, None]
    n_c = torch.linalg.norm(cand_vec, dim=2)
    eucl = torch.sqrt(torch.clamp(n_s**2 + n_c**2 - 2 * dot, min=0.0))
    has_emb = valid & (n_c > 1e-9)
    feat = torch.where(has_emb, eucl, -1).to(torch.float32)
    cols = [feat if i == F // 2 else dot for i in range(F)]
    return dot, n_s, n_c, feat, torch.stack(cols, dim=2)


def tail_emulated(dot, n_s, n_c, valid):
    """The same tail from the same float32 terms, each operation in float64
    and rounded to float32 (exact for +, -, * and sqrt)."""
    def r(x):
        return x.to(torch.float32).to(torch.float64)

    d, s, c = dot.double(), n_s.double(), n_c.double()
    inner = r(r(r(s * s) + r(c * c)) - r(2 * d))
    eucl = r(torch.sqrt(torch.clamp(inner, min=0.0)))
    return torch.where(valid & (n_c > 1e-9), eucl, -1.0).to(torch.float32)


def ulps(a, b):
    """Float32 ulps between a and b, elementwise (same-sign values)."""
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def probe_once(seed):
    """One similarity block on fresh seeded inputs, run twice. -> (None
    when right, else a dict of what was wrong; the largest ulp distance
    of a right run's tail from the emulation)."""
    g = torch.Generator().manual_seed(seed)
    ses_emb = torch.randn((S, D), generator=g) * 0.3
    cand_vec = torch.randn((S, C, D), generator=g) * 0.3
    cand_vec[:, :4] = ses_emb[:, None]          # near-equal rows: cancellation
    valid = torch.rand((S, C), generator=g) < 0.9
    dot, n_s, n_c, feat, stacked = tail_f32(ses_emb, cand_vec, valid)
    again = tail_f32(ses_emb, cand_vec, valid)
    want = tail_emulated(dot, n_s, n_c, valid)
    bad = {}
    for name, a, b in zip(("dot", "n_s", "n_c", "feature", "stacked"),
                          (dot, n_s, n_c, feat, stacked), again):
        diff = a != b
        if bool(diff.any()):
            rows = diff.reshape(diff.shape[0], -1).any(1).nonzero()[:, 0]
            bad[f"{name} (second run)"] = {
                "entries": int(diff.sum()), "shares": sorted({int(r) // SHARE for r in rows}),
                "max_abs": float((a.double() - b.double()).abs().max())}
    terms = {"dot": (dot, torch.einsum("sd,scd->sc", ses_emb.double(), cand_vec.double())),
             "n_s": (n_s, torch.linalg.norm(ses_emb.double(), dim=1)[:, None]),
             "n_c": (n_c, torch.linalg.norm(cand_vec.double(), dim=2))}
    for name, (got, ref) in terms.items():
        err = float(((got.double() - ref).abs() / ref.abs().clamp(min=1.0)).max())
        if err > 1e-5:
            bad[name] = err
    normal = int(ulps(feat, want).max())
    for name, got in (("feature", feat), ("stacked", stacked[:, :, F // 2])):
        diff = ulps(got, want) > TAIL_ULPS
        if bool(diff.any()):
            rows = diff.any(1).nonzero()[:, 0]
            shares = sorted({int(r) // SHARE for r in rows})
            d = (got - want).abs()[diff]
            bad[name] = {"entries": int(diff.sum()), "shares": shares,
                         "max_abs": float(d.max()),
                         "max_rel": float((d / want[diff].abs().clamp(min=1e-30)).max())}
    return (bad or None), normal


def child(args):
    state = {"torch": torch.__version__, "threads": torch.get_num_threads(),
             "capability": torch.backends.cpu.get_cpu_capability()}
    t0 = time.perf_counter()
    batches = history(args.history_seconds, args.seed)
    hist_s = time.perf_counter() - t0
    found, normal = [], 0
    for i in range(args.loops):
        bad, ulp = probe_once(args.seed * 1000 + i)
        normal = max(normal, ulp)
        if bad:
            found.append({"loop": i, **bad})
            print(f"# fault 1 reproduced, seed {args.seed} loop {i}: {json.dumps(bad)}",
                  flush=True)
    print(json.dumps({"child": args.seed, "history_batches": batches,
                      "history_s": round(hist_s, 1), "loops": args.loops,
                      "bad_loops": [f["loop"] for f in found], "found": found,
                      "max_tail_ulps": normal, **state}),
          flush=True)


def parent(args):
    if not torch.cuda.is_available():
        print("probe_fault1_tail: needs a CUDA device", file=sys.stderr)
        return 2
    card = smi()
    print(card, flush=True)
    results, procs = [], []
    seeds = list(range(1, args.processes + 1))
    cmd = [sys.executable, os.path.abspath(__file__), "--child",
           "--history-seconds", str(args.history_seconds), "--loops", str(args.loops)]
    while seeds or procs:
        while seeds and len(procs) < args.parallel:
            procs.append(subprocess.Popen(cmd + ["--seed", str(seeds.pop(0))],
                                          stdout=subprocess.PIPE, text=True))
        p = procs.pop(0)
        out, _ = p.communicate()
        lines = out.strip().splitlines()
        for ln in lines[:-1]:
            print(ln, flush=True)
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"child failed with {p.returncode}")
        res = json.loads(lines[-1])
        print(f"# child {res['child']}: {res['history_batches']} history batches in "
              f"{res['history_s']} s, bad loops {res['bad_loops']}", flush=True)
        results.append(res)
    bad = [r for r in results if r["bad_loops"]]
    print(json.dumps({
        "processes": len(results), "loops": args.loops,
        "processes_with_fault": len(bad),
        "first_loop_faults": sum(1 for r in bad if 0 in r["bad_loops"]),
        "bad_loops": sum(len(r["bad_loops"]) for r in results),
        "max_tail_ulps_of_right_runs": max(r["max_tail_ulps"] for r in results),
        "torch": results[0]["torch"], "cuda": torch.version.cuda,
        "capability": results[0]["capability"], "threads": results[0]["threads"],
        "card": card}))
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=8)
    ap.add_argument("--parallel", type=int, default=2)
    ap.add_argument("--history-seconds", type=float, default=150.0)
    ap.add_argument("--loops", type=int, default=40)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args)
        return 0
    return parent(args)


if __name__ == "__main__":
    sys.exit(main())
