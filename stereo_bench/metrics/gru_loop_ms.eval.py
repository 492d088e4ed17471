"""Stream milliseconds a tick between CUDA events around the model
instance's `_gru_update` calls (the update block and the lookup), summed
over the tick's iterations, mean over the traced ticks; None where the
model has no such method."""


def read(run):
    ms = run["record"]["stage_ms"].get("_gru_update")
    return sum(ms) / len(ms) if ms else None
