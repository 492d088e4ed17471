"""The end-to-end arithmetic on synthetic timelines."""

import pytest

from stereo_bench import window


def _steady(n, period=0.25, pairs=4, start=0.0):
    return [(start + i * period, start + (i + 1) * period, pairs) for i in range(n)]


def test_rate_and_tail_of_a_steady_loop():
    ticks = _steady(100)
    assert window.rate(ticks) == pytest.approx(400 / 25.0)
    assert window.percentile(window.latencies_ms(ticks), 95) == pytest.approx(250.0)


def test_a_stall_moves_both_the_rate_and_the_tail():
    ticks = _steady(100)
    # one tick in ten stalls for a second: the closed loop waits on it
    stalled, t = [], 0.0
    for i in range(100):
        d = 0.25 + (1.0 if i % 10 == 7 else 0.0)
        stalled.append((t, t + d, 4))
        t += d
    assert window.rate(stalled) < 0.85 * window.rate(ticks)
    assert window.percentile(window.latencies_ms(stalled), 95) > 1.2 * window.percentile(
        window.latencies_ms(ticks), 95)


def test_idle_time_between_ticks_counts_in_the_window():
    ticks = [(0.0, 0.25, 4), (1.25, 1.5, 4)]  # a second of nothing between them
    assert window.rate(ticks) == pytest.approx(8 / 1.5)


def test_nearest_rank_percentile():
    assert window.percentile(list(range(1, 101)), 95) == 95
    assert window.percentile([3.0], 95) == 3.0
    assert window.percentile([1, 2], 50) == 1
