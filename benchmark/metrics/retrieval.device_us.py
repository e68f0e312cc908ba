"""retrieval.device_us: device time on the producer's stream
(Retriever.iter_run: its host-to-device copies and retrieve_batch's
kernels, K1 and K2 among them) per session served in the traced slice."""

LAYER = "retrieval"
UNIT = "us/session"
MOVES = {"serve": "sessions_per_s", "nearline": "request_p90_ms"}


def read(summary):
    if summary.get("retrieval_s") is None or not summary.get("sessions"):
        return None
    if summary["retrieval_s"] <= 0:
        return None
    return 1e6 * summary["retrieval_s"] / summary["sessions"]
