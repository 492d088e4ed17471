"""Stream milliseconds a tick between CUDA events around the model
instance's `_upsample_dense` (the LIIF dense decode), mean over the traced
ticks; None where the model has no such method."""


def read(run):
    ms = run["record"]["stage_ms"].get("_upsample_dense")
    return sum(ms) / len(ms) if ms else None
