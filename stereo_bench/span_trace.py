"""The program's own spans (`anystereo_tpu_torch.utils.profiling.span`) over
the traced stretch, put on the device trace's clock: each stage's stream
time, the host's CUDA launch calls inside each span, and the device's idle
time split by whether the host was inside an eval step.

`SpanStretch` is the traced stretch with the program's spans recorded
(`record_spans()` over the stretch alone) and its `record()` given a
`spans` key (`reduce_spans`); `SPAN_METRICS` are the per-layer metrics
that read it (`metrics/<name>.py`).  The harness does not yet enter the
recorder itself, so a traced run reports them only through this module:

    python3 -m stereo_bench.span_trace --workload <cell> --seed <n> --seconds <s> --trace 1

which is `stereo_bench.run` with `SpanStretch` in place of the harness's
stretch and `SPAN_METRICS` beside the cell's per-layer metrics.
"""

from __future__ import annotations

import bisect
import sys
from typing import Dict, List, Optional

from stereo_bench.harness import TRACE_FROM, TRACE_TICKS, TracedStretch, log

CELLS = ["igev.rig16_kitti", "raft.rig16_kitti"]
STAGES = ("matching", "cost", "context", "gru", "decode")
LAYER = "stages: nn/model.AnyStereo._forward"


def _metric(name: str, unit: str, source: str, layer: str = LAYER) -> dict:
    return {"name": name, "unit": unit, "better": "lower", "source": source, "layer": layer,
            "moves": "pairs_per_s", "workloads": list(CELLS)}


SPAN_METRICS = [
    _metric("matching_ms.eval", "ms", "program_span"),
    _metric("cost_ms.eval", "ms", "program_span"),
    _metric("context_ms.eval", "ms", "program_span"),
    _metric("gru_span_ms.eval", "ms", "program_span"),
    _metric("decode_span_ms.eval", "ms", "program_span"),
    _metric("gru_launches_per_iter.eval", "launches", "program_span"),
    _metric("step_idle_ms.eval", "ms", "device_trace", "entry: train/step.make_eval_step into nn/model.AnyStereo.forward"),
]

# Host calls that put work on the device: kernels (runtime and driver
# launches), copies and sets.
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCH_CALLS)


def trace_events(prof):
    """(host events, device events) of a finished `torch.profiler.profile`,
    each [(start us, end us, name)] sorted by start: the host's CUDA runtime
    and driver calls, and every device activity (kernels, copies, sets)."""
    from torch.autograd import DeviceType

    host, device = [], []
    for ev in prof.events():
        item = (ev.time_range.start, ev.time_range.end, ev.name)
        (device if ev.device_type == DeviceType.CUDA else host).append(item)
    return sorted(host), sorted(device)


def _interval(record: dict) -> List[float]:
    """A span's host interval on the trace's clock: its boundaries anchored
    on their own cudaEventRecord calls where the trace has them."""
    return record["anchor_us"] or record["trace_us"]


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a: float, b: float, intervals) -> float:
    """Length of [a, b] inside the union of sorted disjoint `intervals`."""
    return sum(max(0.0, min(b, e) - max(a, s)) for s, e in intervals)


def innermost(records: List[dict], t: float) -> Optional[dict]:
    """The innermost span whose host interval holds trace time t."""
    live = [r for r in records if _interval(r)[0] <= t < _interval(r)[1]]
    return max(live, key=lambda r: (_interval(r)[0], r["id"])) if live else None


def reduce_spans(records: List[dict], host, device, top: int = 10) -> dict:
    """What the span metrics read, from the recorder's records placed on the
    trace (`SpanRecorder.collect(prof)`) and `trace_events(prof)`:

    - `spans`: each record with `launch_calls`, the host launch calls
      (`is_launch`) whose start lies in its interval (its children's too);
    - `launch_calls`: {"in_spans", "outside"} over the stretch, and
      `device_ops`, the device's kernels, copies and sets;
    - `idle_ms`: the device's idle time between its first and last
      activity, {"eval_step": inside an `eval_step` span's host interval,
      "outside": the rest (the tick boundary: the copy back, the loop)};
    - `idle_gaps`: the `top` longest idle gaps, [innermost span open at the
      gap's start or "no span", ms];
    - `anchor_gap_us`: the largest distance, on the trace's clock, of a
      boundary's own cudaEventRecord call from the host stamps taken just
      before and just after it (None without such calls)."""
    calls = sorted(s for s, _, name in host if is_launch(name))
    out = []
    for r in records:
        a, b = _interval(r)
        out.append(dict(r, launch_calls=bisect.bisect_left(calls, b) - bisect.bisect_left(calls, a)))
    roots = _merged(_interval(r) for r in records if r["parent"] is None)
    inside = sum(bisect.bisect_left(calls, b) - bisect.bisect_left(calls, a) for a, b in roots)
    busy = _merged((s, e) for s, e, _ in device)
    gaps = [(busy[k][1], busy[k + 1][0]) for k in range(len(busy) - 1)]
    steps = _merged(_interval(r) for r in records if r["name"] == "eval_step")
    in_step = sum(_overlap(a, b, steps) for a, b in gaps)
    idle = sum(b - a for a, b in gaps)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    anchored = [r for r in records if r["anchor_us"]]
    return {
        "spans": out,
        "launch_calls": {"in_spans": inside, "outside": len(calls) - inside},
        "device_ops": len(device),
        "idle_ms": {"eval_step": in_step / 1e3, "outside": (idle - in_step) / 1e3},
        "idle_gaps": [[(innermost(records, a) or {"name": "no span"})["name"], (b - a) / 1e3] for a, b in longest],
        "anchor_gap_us": max((max(0.0, a - x, x - b) for r in anchored
                              for x, a, b in zip(r["anchor_us"], r["trace_us"], r["record_us"])), default=None),
    }


def steps(spans: dict) -> List[dict]:
    return [r for r in spans["spans"] if r["name"] == "eval_step"]


def stage_ms(record: dict, name: str) -> Optional[float]:
    """Stream ms a traced tick of the spans `name` under an `eval_step`,
    summed over the tick and averaged over the ticks; None where the record
    has no spans, no eval step or no such span, or the spans have no stream
    time (no card)."""
    spans = record.get("spans")
    if not spans or not steps(spans):
        return None
    roots = {r["id"] for r in steps(spans)}
    ms = [r["stream_ms"] for r in spans["spans"] if r["name"] == name and r["root"] in roots]
    if not ms or None in ms:
        return None
    return sum(ms) / len(roots)


def log_spans(spans: dict, tick_ms: List[float]) -> None:
    """The stages of the traced ticks, the launch calls' split, the clock's
    check and the longest idle gaps, on standard error."""
    recs = spans["spans"]
    ticks = max(len(steps(spans)), 1)
    lags = sorted(x - a for r in recs if r["anchor_us"] for x, a in zip(r["anchor_us"], r["trace_us"]))
    log(f"[spans] traced ticks ms {' '.join(f'{t:.1f}' for t in tick_ms)}; {len(recs)} spans; the largest gap "
        f"between a boundary's stamps on the trace's clock and its own cudaEventRecord: {spans['anchor_gap_us']} us"
        + (f" (the call starts {lags[len(lags) // 2]:.1f} us after the first stamp, median; "
           f"{lags[0]:.1f} to {lags[-1]:.1f})" if lags else ""))
    log(f"[spans] {'stage':<12} {'spans':>6} {'stream ms/tick':>15} {'host launches':>14}  hand-written launches")
    for name in ("eval_step",) + STAGES + tuple(sorted({r["name"] for r in recs} - set(STAGES) - {"eval_step"})):
        mine = [r for r in recs if r["name"] == name]
        if not mine:
            continue
        ms = None if None in [r["stream_ms"] for r in mine] else sum(r["stream_ms"] for r in mine) / ticks
        kernels: Dict[str, int] = {}
        for r in mine:
            for k, n in r["launches"].items():
                kernels[k] = kernels.get(k, 0) + n
        log(f"[spans] {name:<12} {len(mine):>6} {'-' if ms is None else f'{ms:.3f}':>15} "
            f"{sum(r['launch_calls'] for r in mine):>14}  {kernels}")
    calls = spans["launch_calls"]
    log(f"[spans] host launch calls {calls['in_spans']} in spans + {calls['outside']} outside = "
        f"{calls['in_spans'] + calls['outside']}; device kernels, copies and sets {spans['device_ops']}")
    log(f"[spans] device idle ms {spans['idle_ms']}; longest gaps [innermost span, ms]: {spans['idle_gaps']}")


class SpanStretch(TracedStretch):
    """The harness's traced stretch with the program's spans recorded over
    it, and a `spans` key in its record."""

    def before(self, i: int) -> None:
        super().before(i)
        if i == TRACE_FROM:
            from anystereo_tpu_torch.utils.profiling import record_spans

            self._recording = record_spans()
            self.recorder = self._recording.__enter__()

    def after(self, i: int) -> None:
        super().after(i)
        if i == TRACE_FROM + TRACE_TICKS - 1:
            self._recording.__exit__(None, None, None)

    def record(self, ticks, flops_per_tick: float, units: int, **extra) -> dict:
        rec = super().record(ticks, flops_per_tick, units, **extra)
        host, device = trace_events(self.prof)
        rec["spans"] = reduce_spans(self.recorder.collect(self.prof), host, device)
        log_spans(rec["spans"], [1e3 * (ticks[j][1] - ticks[j][0]) for j in range(len(ticks)) if self.covers(j)])
        return rec


def main(argv=None) -> int:
    from stereo_bench import cell, harness, run

    real = cell.load_cell

    def load_cell(bench, workload, root=cell.HERE):
        c = real(bench, workload, root)
        c.per_layer = c.per_layer + [m for m in SPAN_METRICS if workload in m["workloads"]]
        return c

    harness.TracedStretch, cell.load_cell = SpanStretch, load_cell
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
