"""The arithmetic of the end-to-end metrics and of their spread."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of ``values``, linear between the two
    nearest ranks (numpy's default rule)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_metrics(intervals_ms, members: int, window_s: float) -> dict:
    """``member_steps_per_s``: every step of the window, each ``members``
    member-steps, over the window's seconds; ``step_ms_p90``: the 90th
    percentile of all step intervals."""
    if window_s <= 0 or not intervals_ms:
        raise ValueError("a window with no steps")
    return {
        "member_steps_per_s": members * len(intervals_ms) / window_s,
        "step_ms_p90": percentile(intervals_ms, 90.0),
    }


def spread(values) -> float:
    """Distance between the first and third quartiles over the median
    (``statistics.quantiles``, n=4)."""
    q1, med, q3 = statistics.quantiles([float(v) for v in values], n=4)
    return (q3 - q1) / med
