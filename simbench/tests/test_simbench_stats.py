"""The p95, rate and spread arithmetic."""
import statistics

import numpy as np
import pytest

from simbench.harness.stats import percentile, rate, spread, trimmed_spread


@pytest.mark.parametrize("n", [1, 2, 7, 100, 401])
@pytest.mark.parametrize("q", [5, 50, 95])
def test_percentile_matches_numpy_linear(n, q):
    xs = np.random.default_rng(n).exponential(size=n)
    assert percentile(list(xs), q) == pytest.approx(np.percentile(xs, q))


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        percentile([], 95)


def test_rate_and_empty_window():
    assert rate(512, 2.0) == 256.0
    with pytest.raises(ValueError):
        rate(1, 0.0)


def test_spread_uses_statistics_quartiles():
    xs = [10.0, 11.0, 9.5, 10.2, 10.8, 9.9]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert spread(xs) == pytest.approx((q3 - q1) / med)


def test_trimmed_spread_drops_the_farthest_run():
    xs = [10.0, 10.1, 9.9, 10.05, 9.95, 30.0]
    assert trimmed_spread(xs) == pytest.approx(spread(xs[:5]))
    assert trimmed_spread(xs) < spread(xs)


def test_trace_reduction_on_hand_events():
    from simbench.harness.profile import NOT_IN_ATEN, WINDOW, reduce_events
    ev = [(WINDOW, False, 100, 200),
          ("aten::einsum", False, 100, 150), ("aten::mm", False, 110, 140),
          ("k1", True, 120, 130), ("k1", True, 125, 135),
          ("k2", True, 160, 170), ("before", True, 50, 90)]
    r = reduce_events(ev)
    assert r["window_s"] == 100e-9
    assert r["busy_s"] == pytest.approx(25e-9)      # [120, 135] ∪ [160, 170]
    assert r["kernel_n"] == {"k1": 2, "k2": 1}
    assert r["aten_calls"] == 2
    idle = dict(r["breakdown"]["idle_gaps"])
    # gaps [100,120] and [135,160] in einsum's span, [170,200] outside it
    assert idle["aten::einsum"] == pytest.approx(45e-9)
    assert idle[NOT_IN_ATEN] == pytest.approx(30e-9)
