"""100 minus the share of the traced stretch's wall time in which some
operation ran on the device (the union of the profiler's device
intervals)."""


def read(run):
    rec = run["record"]
    return 100.0 * (1.0 - rec["busy_s"] / rec["traced_s"])
