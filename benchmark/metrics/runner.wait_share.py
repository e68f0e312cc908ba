"""runner.wait_share: the share of the traced slice in which the producer
(pipeline/runner.py::pipelined_consume's calling thread) waited for the
consumer, from pipelined_consume's own "wait" seconds."""

LAYER = "runner"
UNIT = "%"
MOVES = {"serve": "sessions_per_s", "nearline": "request_p90_ms"}


def read(summary):
    runner = summary.get("runner") or {}
    if "wait" not in runner or not summary.get("window_s"):
        return None
    return 100.0 * runner["wait"] / summary["window_s"]
