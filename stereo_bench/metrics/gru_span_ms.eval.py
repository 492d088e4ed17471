"""Stream milliseconds a traced tick of the program's `gru` spans, summed
over the tick's iterations, mean over the traced ticks: the layer of
`gru_loop_ms.eval`, timed inside the program; None where the record has no
spans."""

from stereo_bench.span_trace import stage_ms


def read(run):
    return stage_ms(run["record"], "gru")
