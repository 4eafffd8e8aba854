"""Tail, rate and interval arithmetic over all samples."""

import math
import statistics

import numpy as np
import pytest

from perfbench import stats


@pytest.mark.parametrize("n", [1, 2, 7, 20, 113])
def test_percentile_is_numpys_linear_rule(n):
    xs = np.random.default_rng(n).exponential(size=n).tolist()
    for q in (50, 95, 99):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_percentile_counts_a_missing_answer_as_late():
    xs = [1.0] * 19 + [math.inf]
    assert stats.percentile(xs, 95) == math.inf
    assert stats.percentile(xs + [1.0] * 20, 95) == 1.0
    assert math.isnan(stats.percentile([], 95))


def test_rate_is_all_work_over_all_time():
    assert stats.rate(300, 40.0) == 7.5
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_length_counts_overlap_once():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 12)]
    assert stats.union_length(iv) == 3 + 1 + 2
    assert stats.union_length(iv, 1.5, 11) == 1.5 + 1 + 1
    assert stats.union_length([]) == 0


def test_gaps_are_the_uncovered_stretches_longest_first():
    assert stats.gaps([(1, 2), (4, 5)], 0, 10) == [(5, 10), (2, 4), (0, 1)]
    assert stats.gaps([(0, 10)], 0, 10) == []


def test_spread_is_the_interquartile_share_of_the_median():
    xs = [10, 11, 12, 13, 14, 15]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == (q3 - q1) / med


def test_in_flight_counts_requests_from_sending_to_their_last_token():
    from types import SimpleNamespace

    from perfbench import harness

    drv = harness.load_module(harness.ROOT / "drivers" / "serve_open.py", "t_serve")
    c = [SimpleNamespace(sent=0.0, times=[1.0, 4.0]), SimpleNamespace(sent=2.0, times=[3.0]),
         SimpleNamespace(sent=3.5, times=[5.0, 6.0]), SimpleNamespace(sent=4.5, times=[])]
    assert drv.in_flight_max(c) == 2
    c.append(SimpleNamespace(sent=1.5, times=[2.5, 3.6]))
    assert drv.in_flight_max(c) == 3
