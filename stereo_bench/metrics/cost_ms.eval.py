"""Stream milliseconds a traced tick of the program's `cost` span (its
CUDA events on the current stream), mean over the traced ticks; None where
the record has no spans."""

from stereo_bench.span_trace import stage_ms


def read(run):
    return stage_ms(run["record"], "cost")
