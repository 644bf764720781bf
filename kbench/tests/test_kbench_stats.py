"""Percentiles over every request, and the spread the bounds are set from."""

import math
import random
import statistics

import pytest

from kbench.stats import percentile, spread


@pytest.mark.parametrize("n", [2, 7, 10, 113, 250])
def test_percentile_matches_statistics(n):
    vals = [random.Random(n).lognormvariate(0, 1) for _ in range(n)]
    qs = statistics.quantiles(vals, n=100, method="inclusive")
    for q in (50, 90, 95):
        assert percentile(vals, q) == pytest.approx(qs[q - 1], rel=1e-12)


def test_percentile_counts_every_request():
    # ten finished at 1 s and one failed: the failure is the slowest
    vals = [1.0] * 10 + [None]
    assert percentile(vals, 50) == 1.0
    assert percentile(vals, 90) == 1.0
    assert percentile(vals, 95) == math.inf
    assert percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_spread_is_quartiles_over_median():
    vals = [10, 11, 12, 13, 14, 15]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert spread(vals) == (q3 - q1) / med
