"""mla_moe.host_us: the consumer thread's time in the program's own span
`otto::rank.mla_moe` (otto_tpu_torch.utils.timing; the MLA + MoE ranker's
encoder: packing the jagged tokens, with its one sync, and launching its
layers, experts and heads, inside `otto::rank.score`) per session served
in the traced slice. The program records the spans of every score_pass
that starts under torch.profiler, so its totals are the traced slice's; a
program without the span reads nothing."""

LAYER = "rank"
UNIT = "us/session"
MOVES = {"serve": "sessions_per_s"}
SPAN = "otto::rank.mla_moe"


def read(summary):
    if not summary.get("busy_s") or not summary.get("sessions"):
        return None
    try:
        from otto_tpu_torch.utils import timing
        totals = timing.span_totals()
    except (ImportError, AttributeError):
        return None
    if SPAN not in totals:
        return None
    return 1e6 * totals[SPAN][1] / summary["sessions"]
