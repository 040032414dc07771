"""The spread arithmetic."""

import statistics

import pytest

from harness import stats


def test_spread_is_the_quartile_distance_over_the_median():
    values = [100.0, 101.0, 99.0, 102.0, 98.0, 100.5]
    q1, q2, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx((q3 - q1) / q2)
