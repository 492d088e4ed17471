"""End-to-end arithmetic of a measured window, on host-clock stamps.

A window starts at its first dispatch and ends when the last unit of work
dispatched before its deadline has reached the host, so it holds all the
work and all the time it took: a stall anywhere in it lowers the rate and,
if it delays a request, raises the tail.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Sequence, Tuple

# (dispatch s, done s, units completed): one tick of pairs or one step of samples
Tick = Tuple[float, float, int]


def window_seconds(ticks: Sequence[Tick]) -> float:
    return ticks[-1][1] - ticks[0][0]


def rate(ticks: Sequence[Tick]) -> float:
    """Units completed over the window's seconds."""
    return sum(n for _, _, n in ticks) / window_seconds(ticks)


def latencies_ms(ticks: Sequence[Tick]) -> List[float]:
    """One latency a unit: its tick's dispatch to its result on the host."""
    return [1e3 * (done - start) for start, done, n in ticks for _ in range(n)]


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of the
    values at or below it."""
    s = sorted(values)
    return s[max(math.ceil(q / 100.0 * len(s)) - 1, 0)]


class SetupClock:
    """Seconds from the process's start to each named point of set-up."""

    def __init__(self, t0: float):
        self.t0 = self.last = t0
        self.parts: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        t = time.perf_counter()
        self.parts[name] = t - self.last
        self.last = t

    @property
    def total(self) -> float:
        return self.last - self.t0
