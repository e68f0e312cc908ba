"""A tiny copy of a serving cell for the CPU tests: the cell's files with
the scale cut (aids, sessions, batch, request size, sample), every width
kept, the kernels' plain twins running on the CPU."""
from __future__ import annotations

import copy

from benchmark import harness


def tiny(workload: str, n_trees: int = 150):
    spec = harness.load_spec()
    _, cfg, traffic = harness.find_cell(spec, workload)
    cfg = copy.deepcopy(cfg)
    cfg.update(n_aids=3000, test_sessions=600, batch_sessions=64)
    if cfg["ranker_backend"] == "gbdt":
        cfg["ranker"]["n_trees"] = n_trees
    # near-line requests stay the smaller, so that a short window holds several
    small = 64 if traffic["sessions_per_request"] < 1024 else 128
    traffic = dict(traffic, sessions_per_request=small,
                   warmup_requests=1, trace_skip_requests=0, trace_requests=1,
                   check_sessions=40, check_longest=16)
    return spec, cfg, traffic
