"""95th percentile over every pair completed in the window of the time
from its tick's dispatch to its disparity on the host (host clock)."""

from stereo_bench import window


def read(run):
    return window.percentile(window.latencies_ms(run["ticks"]), 95.0)
