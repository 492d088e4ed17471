"""Stream milliseconds a traced tick of the program's `decode` span, mean
over the traced ticks: the layer of `decode_ms.eval`, timed inside the
program; None where the record has no spans."""

from stereo_bench.span_trace import stage_ms


def read(run):
    return stage_ms(run["record"], "decode")
