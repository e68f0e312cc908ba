"""device.idle_share: the share of the traced slice in which no kernel,
copy or fill ran on the card (the union of the device's operations from
torch.profiler's trace, against the slice's length on the host clock)."""

LAYER = "device"
UNIT = "%"
MOVES = {"serve": "sessions_per_s", "nearline": "request_p90_ms"}


def read(summary):
    if not summary.get("busy_s") or not summary.get("window_s"):
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
