"""runner.consumer_wait_share: the consumer thread's time waiting for the
producer, in the program's own span `otto::runner.get_wait`
(otto_tpu_torch.utils.timing; pipelined_consume's queue get), over the
summed time of the requests, `otto::runner.score_pass`, in the traced
slice. The program records the spans of every score_pass that starts
under torch.profiler, so its totals are the traced slice's; a program
without the span registry reads nothing."""

LAYER = "runner"
UNIT = "%"
MOVES = {"serve": "sessions_per_s", "nearline": "request_p90_ms"}
WAIT = "otto::runner.get_wait"
REQUEST = "otto::runner.score_pass"


def read(summary):
    if not summary.get("busy_s"):
        return None
    try:
        from otto_tpu_torch.utils import timing
        totals = timing.span_totals()
    except (ImportError, AttributeError):
        return None
    if WAIT not in totals or not totals.get(REQUEST, (0, 0.0))[1]:
        return None
    return 100.0 * totals[WAIT][1] / totals[REQUEST][1]
