"""mfu: the whole step's share of the card's peak: the rankers' own
operations over the candidate rows the sessions really have (valid slots,
summed on the card as the consumer scores them), over the traced slice's
length and the published peak of the precision they compute in
(benchmark/peaks.py: GBDT, one comparison a level and one leaf add a tree,
against FP32 at 67 TFLOP/s; MLP, the tower's products, computed in
float64, against FP64 tensor cores at 67 TFLOP/s)."""

LAYER = "whole step"
UNIT = "%"
MOVES = {"serve": "sessions_per_s", "nearline": "request_p90_ms"}


def read(summary):
    if not summary.get("rank_ops") or not summary.get("window_s") \
            or not summary.get("busy_s"):
        return None
    return 100.0 * summary["rank_ops"] / (summary["window_s"] * summary["rank_peak"])
