"""retrieval.host_us: the producer thread's time in the program's own spans
`otto::retrieval.pack` and `otto::retrieval.batch` (otto_tpu_torch
.utils.timing; Retriever.iter_run: packing, and per microbatch the session
lookup, the host-to-device copies, Stages A-E and the keep filter) per
session served in the traced slice. The program records the spans of
every score_pass that starts under torch.profiler, so its totals are the
traced slice's; a program without the span registry reads nothing."""

LAYER = "retrieval"
UNIT = "us/session"
MOVES = {"serve": "sessions_per_s", "nearline": "request_p90_ms"}
SPANS = ("otto::retrieval.pack", "otto::retrieval.batch")


def read(summary):
    if not summary.get("busy_s") or not summary.get("sessions"):
        return None
    try:
        from otto_tpu_torch.utils import timing
        totals = timing.span_totals()
    except (ImportError, AttributeError):
        return None
    if "otto::retrieval.batch" not in totals:
        return None
    return 1e6 * sum(totals[n][1] for n in SPANS if n in totals) / summary["sessions"]
