"""rank.device_us: device time on the consumer's streams (score_topk_multi:
the three rankers, the top-k and the pull of the lists) per session served
in the traced slice."""

LAYER = "rank"
UNIT = "us/session"
MOVES = {"serve": "sessions_per_s", "nearline": "request_p90_ms"}


def read(summary):
    if summary.get("rank_s") is None or not summary.get("sessions"):
        return None
    if summary["rank_s"] <= 0:
        return None
    return 1e6 * summary["rank_s"] / summary["sessions"]
