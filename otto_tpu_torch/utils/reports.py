"""Report names and numeric summaries.

Counterpart of otto_tpu/utils/reports.py: `{prefix}-{timestamp}[-tag]
[-githash]` artifact names and percentile tables of a 1-D array.
"""
from __future__ import annotations

import subprocess
from datetime import datetime
from typing import Dict, Optional, Sequence

import numpy as np


def git_hash(short: int = 8) -> Optional[str]:
    """The first `short` hex digits of HEAD's commit, or None outside a
    git checkout."""
    try:
        out = subprocess.check_output(
            ["git", "log", "-1", "--pretty=format:%H"], stderr=subprocess.DEVNULL)
        return out.decode()[:short] or None
    except Exception:
        return None


def timestamp() -> str:
    return datetime.now().strftime("%Y%m%d%H%M%S")


def report_name(prefix: str = "submission", tag: Optional[str] = None) -> str:
    """`{prefix}-{timestamp}[-tag][-githash]`."""
    parts = [prefix, timestamp()]
    if tag:
        parts.append(tag)
    h = git_hash()
    if h:
        parts.append(h)
    return "-".join(parts)


def describe_numeric(
    values: np.ndarray,
    percentiles: Sequence[float] = (0.01, 0.05, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95, 0.99),
) -> Dict[str, float]:
    """count, mean, std, min, max and the given percentiles of a 1-D array
    (NaN for an empty one)."""
    v = np.asarray(values, np.float64)
    nan = float("nan")
    out = {
        "count": float(v.size),
        "mean": float(v.mean()) if v.size else nan,
        "std": float(v.std()) if v.size else nan,
        "min": float(v.min()) if v.size else nan,
        "max": float(v.max()) if v.size else nan,
    }
    for p in percentiles:
        out[f"{int(p * 100)}%"] = float(np.percentile(v, p * 100)) if v.size else nan
    return out
