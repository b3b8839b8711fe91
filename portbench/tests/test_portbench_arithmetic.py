"""The benchmark's arithmetic: the solve kernels' roofline bounds (as
PERF.md's kernel table gives them), the window's rate and tail on
synthetic step intervals, and the spread statistic of the bounds."""

import pytest

from portbench import roofline, stats


@pytest.mark.parametrize("kernel, systems, N, dim, bound_us", [
    ("K1", 1, 256, 2, 1.420),
    ("K1", 8, 256, 2, 11.356),
    ("K5", 1, 128, 3, 56.391),
    ("K5", 5, 64, 3, 36.070),
])
def test_solve_bound_matches_kernel_table(kernel, systems, N, dim, bound_us):
    got = roofline.solve_bound_s(kernel, systems, (N + 1) ** dim, iterations=1.0) * 1e6
    assert round(got, 3) == bound_us


def test_solve_bound_turns_to_operations_past_many_iterations():
    n = 129 ** 3
    by_bytes = roofline.solve_bytes("K5", 1, n) / roofline.HBM_BYTES_PER_S
    assert roofline.solve_bound_s("K5", 1, n, 1.0) == by_bytes
    many = roofline.solve_bound_s("K5", 1, n, 100.0)
    assert many == roofline.solve_ops("K5", 1, n, 100.0) / roofline.PEAK_F64_FLOPS
    assert many > by_bytes


def test_percentile_is_numpy_linear_rule():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.percentile(xs, 0) == 1.0
    assert stats.percentile(xs, 100) == 5.0
    assert stats.percentile(xs, 90) == pytest.approx(4.6)
    assert stats.percentile([7.0], 90) == 7.0


def test_rate_and_p90_over_all_intervals():
    steady = [200.0] * 100
    m = stats.window_metrics(steady, members=1, window_s=20.0)
    assert m["member_steps_per_s"] == pytest.approx(5.0)
    assert m["step_ms_p90"] == pytest.approx(200.0)
    m32 = stats.window_metrics([50.0] * 100, members=32, window_s=5.0)
    assert m32["member_steps_per_s"] == pytest.approx(640.0)


def test_a_stall_moves_the_tail_and_the_rate():
    base = [200.0] * 100
    stalled = [200.0] * 85 + [1200.0] * 15  # a stall of 15 s spread over 15 steps
    m0 = stats.window_metrics(base, 1, sum(base) / 1e3)
    m1 = stats.window_metrics(stalled, 1, sum(stalled) / 1e3)
    assert m1["step_ms_p90"] > 5 * m0["step_ms_p90"]
    assert m1["member_steps_per_s"] < 0.7 * m0["member_steps_per_s"]


def test_a_window_without_steps_is_refused():
    with pytest.raises(ValueError):
        stats.window_metrics([], 1, 10.0)


def test_spread_is_interquartile_over_median():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    vals = [10.0, 10.0, 11.0, 9.0, 10.0, 10.5]
    import statistics

    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)
