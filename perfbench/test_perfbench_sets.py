"""The spreads the bounds are set from, by hand."""
import pytest

from perfbench import sets


def test_spread_is_the_quartile_distance_over_the_median():
    # statistics.quantiles(n=4) of 1..6 ("exclusive"): Q1 1.75, Q3 5.25; median 3.5
    assert sets.spread([6, 1, 5, 2, 4, 3]) == pytest.approx((5.25 - 1.75) / 3.5)


def test_trimmed_spread_leaves_out_the_farthest_run():
    values = [100.0, 101.0, 99.0, 100.5, 99.5, 130.0]
    assert sets.trimmed_spread(values) == pytest.approx(sets.spread(values[:5]))
    assert sets.trimmed_spread(values) < sets.spread(values)
