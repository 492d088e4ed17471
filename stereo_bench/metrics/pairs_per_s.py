"""Pairs whose disparity reached the host in the window, over the window's
seconds (host clock; the window ends with the last tick dispatched before
its deadline)."""

from stereo_bench import window


def read(run):
    return window.rate(run["ticks"])
