"""Device idle milliseconds a traced tick while the host was inside the
program's `eval_step` span: idle that the program's own launches leave
(the rest of the idle time is at the tick boundary: the copy back, the
loop); None where the record has no spans."""

from stereo_bench.span_trace import steps


def read(run):
    spans = run["record"].get("spans")
    if not spans or not steps(spans):
        return None
    return spans["idle_ms"]["eval_step"] / len(steps(spans))
