"""Host milliseconds of the eval step's call, before the host waits for its
result: the launch cost of a tick.  Mean over the window's ticks outside the
traced stretch."""


def read(run):
    ms = run["record"]["enqueue_ms"]
    return sum(ms) / len(ms) if ms else None
