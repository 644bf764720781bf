"""Percentiles over every request of a window, and the spread the bounds use."""

from __future__ import annotations

import math
import statistics


def percentile(values: list, q: float) -> float:
    """The q-th percentile of all values by linear interpolation between
    order statistics, as `statistics.quantiles(values, n=100,
    method="inclusive")` places them. A missing value (None: a request that
    failed) is +inf, so a tail that reaches one is inf."""
    vals = sorted(math.inf if v is None else float(v) for v in values)
    if not vals:
        raise ValueError("no values")
    pos = (len(vals) - 1) * q / 100.0
    lo = int(pos)
    frac = pos - lo
    if frac == 0.0:
        return vals[lo]
    a, b = vals[lo], vals[lo + 1]
    return math.inf if math.inf in (a, b) else a + frac * (b - a)


def spread(values: list) -> float:
    """The distance between the first and third quartiles as a share of the
    median, by `statistics.quantiles(values, n=4)`."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
