"""`stereo_bench.span_trace`'s traced run with each device activity put in
the program's span whose host launch call started it (CUPTI correlates a
kernel with the CUDA API call that launched it), so the layout
transposes cuDNN runs beside its convolutions (kernels named `nchwToNhwc`
and `nhwcToNchw`) are counted and timed inside the `gru` spans and outside
them; and the stretch's device time by kind of kernel.

    python3 -m stereo_bench.layout_trace --workload <cell> --seed <n> --seconds <s> --trace 1

prints `stereo_bench.run`'s lines and, on standard error, `[layout]` lines.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

from stereo_bench import span_trace
from stereo_bench.harness import log

TRANSPOSES = ("nchwToNhwc", "nhwcToNchw")
NO_CALL = "no launch call"
NO_SPAN = "no span"

# Kinds of device activity by a part of the kernel's name, first match wins.
KINDS = (
    ("layout transposes", TRANSPOSES),
    ("concatenations", ("CatArrayBatchedCopy",)),
    ("vectorised elementwise", ("vectorized_elementwise_kernel",)),
    ("unvectorised elementwise", ("elementwise_kernel",)),
    ("convolutions", ("implicit_gemm", "fprop", "dgrad", "wgrad", "conv")),
    ("GEMMs", ("gemm", "xmma", "cutlass")),
    ("copies", ("Memcpy", "Memset", "copy")),
)


def kind(name: str) -> str:
    return next((k for k, parts in KINDS if any(p in name for p in parts)), "other")


def launched_in(records: List[dict], prof) -> List[Tuple[str, str, float]]:
    """Each device activity of a finished `torch.profiler.profile` as (the
    name of the innermost span, of `records` placed on its trace by
    `SpanRecorder.collect(prof)`, whose host interval holds the start of the
    call that launched it, else NO_SPAN, or NO_CALL where the trace has no
    such call; the activity's name; its device us)."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    calls, device = {}, []
    for ev in results.events():
        if ev.device_type() == DeviceType.CUDA:
            device.append(ev)
        elif span_trace.is_launch(ev.name()):
            calls[ev.correlation_id()] = (ev.start_ns() - t0) / 1e3
    out = []
    for ev in device:
        t = calls.get(ev.correlation_id())
        owner = NO_CALL if t is None else (span_trace.innermost(records, t) or {"name": NO_SPAN})["name"]
        out.append((owner, ev.name(), ev.duration_ns() / 1e3))
    return out


def transposes_by_span(ops: List[Tuple[str, str, float]]) -> Dict[str, List[float]]:
    """{span name: [layout transposes, their device ms]} of `launched_in`'s
    activities."""
    out: Dict[str, List[float]] = {}
    for owner, name, us in ops:
        if any(t in name for t in TRANSPOSES):
            acc = out.setdefault(owner, [0, 0.0])
            acc[0] += 1
            acc[1] += us / 1e3
    return out


class LayoutStretch(span_trace.SpanStretch):
    def record(self, ticks, flops_per_tick: float, units: int, **extra) -> dict:
        rec = super().record(ticks, flops_per_tick, units, **extra)
        ticks_traced = max(len(span_trace.steps(rec["spans"])), 1)
        gru = sum(1 for r in rec["spans"]["spans"] if r["name"] == "gru")
        ops = launched_in(rec["spans"]["spans"], self.prof)
        log(f"[layout] {len(ops)} device activities over {ticks_traced} ticks, {gru} gru spans; "
            f"without a launch call: {sum(1 for o, _, _ in ops if o == NO_CALL)}")
        for owner, (n, ms) in sorted(transposes_by_span(ops).items()):
            log(f"[layout] transposes launched in {owner}: {n} ({n / ticks_traced:.1f} a tick"
                + (f", {n / gru:.2f} a gru span" if owner == "gru" and gru else "")
                + f"), {ms:.3f} device ms ({ms / ticks_traced:.3f} a tick)")
        kinds: Dict[str, List[float]] = {}
        for name, (ms, n) in rec["kernels"].items():
            acc = kinds.setdefault(kind(name), [0.0, 0])
            acc[0] += ms
            acc[1] += n
        for k, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
            log(f"[layout] kind {k:<32} {ms / 1e3:.4f} s over the traced ticks, {n} activities")
        for name, (ms, n) in sorted(rec["kernels"].items(), key=lambda kv: -kv[1][0])[:30]:
            log(f"[layout] kernel {ms / 1e3:.4f} s {n:>7} {name[:160]}")
        return rec


def main(argv=None) -> int:
    span_trace.SpanStretch = LayoutStretch
    return span_trace.main(argv)


if __name__ == "__main__":
    sys.exit(main())
