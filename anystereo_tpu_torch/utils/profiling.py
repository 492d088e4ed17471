"""Measuring helpers of the port (the JAX package's `utils/profiling.py`,
same names and contracts, PyTorch inside).

  * `count_params`, `flops_estimate` — startup reporting (the reference
    prints a parameter count, train_continuous_IGEV.py:185).
  * `device_timer` — latency of a call, each ended by a host copy of its
    output, so the time holds the device's work and not only the enqueue.
  * `pipelined_per_call` — steady-state seconds a call by K-vs-1
    differencing, the harness `bench.py` times with.
  * `trace` — a `torch.profiler` context that writes a Chrome trace.
  * `H100_PEAK`, `KernelSpec`, `roofline` — a kernel's achieved rates
    against the card's ceilings.
  * `span`, `record_spans`, `launch_counts` — the program's own spans
    (the eval and train steps, the forward's stages, the loader's wait),
    recorded only inside `record_spans()`, with each span's stream time,
    host interval and hand-written kernel launches, and placed on a
    `torch.profiler` trace's clock.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import os
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nest of tuples (named ones too), lists and dicts,
    in order; other leaves (None, numbers) are skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in _leaves(sub)]
    return []


def count_params(model_or_tensors) -> int:
    """Parameters of a module (not its buffers: BatchNorm's running
    statistics are not in the JAX `params` collection either), or elements
    of a nest of tensors."""
    if isinstance(model_or_tensors, torch.nn.Module):
        return sum(p.numel() for p in model_or_tensors.parameters())
    return sum(t.numel() for t in _leaves(model_or_tensors))


def flops_estimate(fn: Callable, *args) -> float:
    """FLOPs of one call of `fn(*args)`, as `torch.utils.flop_counter`
    counts them: convolutions and matrix products (and attention) at every
    output position, a multiply-add as two.  Elementwise work, norms and
    reductions count nothing, nor do the hand-written kernels, which are
    called through `ctypes` and are no ATen ops.

    The JAX package's `flops_estimate` reads XLA's cost analysis of its
    compiled HLO, which counts elementwise work too and has its own rules
    for padded windows: on the IGEV eval forward at 1x64x128, `max_disp`
    64, 2 iterations, fp32, this count is 1.21x XLA's (12.60 against 10.38
    GFLOP), so the two are not interchangeable.  The call runs once, for
    real; an error it raises is raised."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def _host_copy(out) -> None:
    leaves = _leaves(out)
    if leaves:
        leaves[0].cpu()


def device_timer(fn: Callable, *args, n: int = 3, warmup: int = 1) -> float:
    """Median seconds a call, each ended by a host copy of the first output
    tensor (which waits for the device)."""
    for _ in range(warmup):
        _host_copy(fn(*args))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        _host_copy(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(statistics.median(times))


def pipelined_per_call(apply_fn, args, k: int = 6, reps: int = 2):
    """Steady-state seconds a call by K-vs-1 differencing.

    `apply_fn(c, *args)` runs one application with the 0-dim fp32 carry `c`
    (on the device of the first tensor in `args`) folded into its inputs,
    and returns any nest of tensors.  A chain of n applications adds
    `sum(x.float()) * 1e-20` over the output tensors to the carry after
    each, so each application depends on the one before it; a chain ends
    in a host read of the carry (`c.item()`), which waits for the device.
    The K-vs-1 difference cancels the host's launch of the first
    application, the final read and the device's tail.  The forwards run
    as the caller's `apply_fn` runs them: no `torch.compile`, no CUDA graph.

    Returns (per_call_s, aux) with aux = {"t1", "tk", "compile_s",
    "first_out"}: `t1` and `tk` the best of `reps` chains of 1 and k,
    `compile_s` the first pass of both chains, and `first_out` the outputs
    of the first application of the first chain (carry 0), which callers
    hold against a direct `apply_fn(0, *args)`, so that a wrong but finite
    chained path cannot post a good number."""
    if k < 2:
        raise ValueError(f"k-vs-1 differencing needs k >= 2, got k={k}")
    device = _leaves(list(args))[0].device

    def chain(n):
        c = torch.zeros((), dtype=torch.float32, device=device)
        first = None
        for i in range(n):
            outs = apply_fn(c, *args)
            c = c + sum(x.float().sum() * 1e-20 for x in _leaves(outs))
            if i == 0:
                first = outs
        return c, first

    t0 = time.perf_counter()
    c, first_out = chain(1)
    c.item()
    chain(k)[0].item()
    compile_s = time.perf_counter() - t0

    def best(n):
        b = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            chain(n)[0].item()
            b = min(b, time.perf_counter() - t0)
        return b

    t1, tk = best(1), best(k)
    per = (tk - t1) / (k - 1)
    return per, {"t1": t1, "tk": tk, "compile_s": compile_s, "first_out": first_out}


@contextlib.contextmanager
def trace(logdir: str):
    """A `torch.profiler` context over the CPU and, where a card is present,
    CUDA activities; on exit it writes `<logdir>/trace.json`, a Chrome trace
    (chrome://tracing, Perfetto).  Yields the profiler, whose
    `key_averages()` sums the events by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# Dense ceilings of one NVIDIA H100 SXM at its 700 W power limit (NVIDIA's
# data sheet, no sparsity); a card set below 700 W reaches less.
H100_PEAK = {
    "bf16_flops": 989e12,  # tensor cores, fp32 accumulate
    "tf32_flops": 495e12,  # tensor cores
    "f32_flops": 67e12,  # outside the tensor cores
    "hbm_bytes_per_s": 3.35e12,
}


@dataclasses.dataclass
class KernelSpec:
    name: str
    flops: float
    bytes_accessed: float
    unit: str = "f32_flops"


def roofline(spec: KernelSpec, measured_s: float,
             peaks: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """Achieved fraction of the compute and bandwidth ceilings."""
    peaks = peaks or H100_PEAK
    achieved_flops = spec.flops / measured_s
    achieved_bw = spec.bytes_accessed / measured_s
    return {
        "seconds": measured_s,
        "gflops": achieved_flops / 1e9,
        "compute_frac": achieved_flops / peaks[spec.unit],
        "gbytes_per_s": achieved_bw / 1e9,
        "bandwidth_frac": achieved_bw / peaks["hbm_bytes_per_s"],
    }


# ---------------------------------------------------------------------- #
# Spans

# The hand-written kernels' wrappers by their names in the kernel table
# (PERF.md): (name, module under ops/kernels/, wrapper).  Each wrapper
# counts its launches in `.launches`.
KERNELS = (
    ("B1 fwd", "lookup", "gather_pyramid_aligned"),
    ("B1 bwd", "lookup", "gather_pyramid_aligned_bwd"),
    ("B2", "gather", "scatter_rows_add"),
    ("B3", "gather", "gather_rows"),
    ("B4 fwd", "lookup_window", "gather_pyramid_window_pm"),
    ("B4 bwd", "lookup_window", "gather_pyramid_window_pm_bwd"),
    ("B5 fwd", "lookup_window", "gather_pyramid_window_t"),
    ("B5 bwd", "lookup_window", "gather_pyramid_window_t_bwd"),
    ("B6 fwd", "lookup_window", "gather_pyramid_window"),
    ("B6 bwd", "lookup_window", "gather_pyramid_window_bwd"),
    ("B7 fwd", "lookup_linear", "gather_window_linear"),
    ("B7 bwd", "lookup_linear", "gather_window_linear_bwd"),
    ("B8 fwd", "lookup_linear", "gather_rows_linear"),
    ("B8 bwd", "lookup_linear", "gather_rows_linear_bwd"),
)


def kernel_wrappers() -> Dict[str, Callable]:
    """{kernel-table name: wrapper} of every hand-written kernel."""
    return {name: getattr(importlib.import_module(f"anystereo_tpu_torch.ops.kernels.{module}"), attr)
            for name, module, attr in KERNELS}


def launch_counts() -> Dict[str, int]:
    """{kernel-table name: launches so far} of every hand-written kernel."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


_recorder: Optional["SpanRecorder"] = None  # set only inside record_spans()
_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A context around one stage of the program, recorded while
    `record_spans()` is active.  Otherwise the one shared no-op context: no
    CUDA event, no profiler range, no allocation, no synchronisation."""
    if _recorder is None:
        return _OFF
    return _Span(_recorder, name, attrs)


@contextlib.contextmanager
def record_spans():
    """Records every `span` of this process while inside; yields the
    `SpanRecorder`, whose `collect()` returns the spans."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("spans are already being recorded")
    _recorder = SpanRecorder()
    try:
        yield _recorder
    finally:
        _recorder = None


def _unix_minus_perf_ns() -> int:
    """`time.time_ns()` less `time.perf_counter_ns()`, from the closest of a
    few bracketed readings."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, unix - (a + b) // 2)
    return best[1]


class _Span:
    __slots__ = ("rec", "name", "attrs", "id", "parent", "root", "host_ns", "record_ns", "events", "counts",
                 "launches", "range")

    def __init__(self, rec: "SpanRecorder", name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        rec = self.rec
        top = rec._stack[-1] if rec._stack else None
        self.id = rec._opened
        rec._opened += 1
        self.parent = None if top is None else top.id
        self.root = self.id if top is None else top.root
        self.counts = rec._counts()
        rec._spans.append(self)
        rec._stack.append(self)
        self.events = None
        if rec.cuda:
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        # each boundary's host stamp is taken just before its event is
        # recorded and again once the record returns: the two bracket its
        # cudaEventRecord call, and lie outside the profiler's range
        self.host_ns = [time.perf_counter_ns(), None]
        if self.events is not None:
            self.events[0].record()
        self.record_ns = [time.perf_counter_ns(), None]
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(f"anystereo/{self.name}")
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if self.range is not None:
            self.range.__exit__(*exc)
        rec._stack.pop()
        self.launches = {n: after - before for n, before, after in zip(rec._names, self.counts, rec._counts())
                         if after != before}
        self.host_ns[1] = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self.record_ns[1] = time.perf_counter_ns()
        return False


class SpanRecorder:
    """The spans of one `record_spans()` extent, kept in memory until
    `collect()`."""

    def __init__(self):
        self.cuda = torch.cuda.is_available()
        wrappers = kernel_wrappers()
        self._names, self._wrappers = list(wrappers), list(wrappers.values())
        self._spans: List[_Span] = []
        self._stack: List[_Span] = []
        self._opened = 0
        self._unix_ns = _unix_minus_perf_ns()

    def _counts(self) -> List[int]:
        return [fn.launches for fn in self._wrappers]

    def collect(self, prof=None) -> List[dict]:
        """The closed spans recorded so far, in the order they opened, as
        plain records (and forgets them); synchronises once on a card.

        Each record: `name`, `attrs`, `id`, `parent` (the enclosing span's
        id, or None), `root` (the outermost enclosing span's id: one eval or
        train step), `host_ns` ([start, end] of `time.perf_counter_ns()`,
        each just before the boundary's CUDA event is recorded), `record_ns`
        (each once the record has returned), `stream_ms` (between the span's
        CUDA events on the current stream; None without a card), `launches`
        ({kernel-table name: launches in the span}, those that launched).
        With `prof`, a finished `torch.profiler.profile`, also `trace_us` and
        `record_us`: `host_ns` and `record_ns` on the trace's clock (the
        microseconds of its events' `time_range`), and `anchor_us`: the start
        of each boundary's own `cudaEventRecord` (or
        `cudaEventRecordWithFlags`) call in the trace, the first to start
        within the boundary's [`trace_us`, `record_us`] bracket, else the
        call nearest it (None where the trace has no such calls)."""
        spans = [s for s in self._spans if s.host_ns[1] is not None]
        self._spans = [s for s in self._spans if s.host_ns[1] is None]
        if self.cuda and spans:
            torch.cuda.synchronize()
        out = [{"name": s.name, "attrs": dict(s.attrs), "id": s.id, "parent": s.parent, "root": s.root,
                "host_ns": list(s.host_ns), "record_ns": list(s.record_ns),
                "stream_ms": None if s.events is None else s.events[0].elapsed_time(s.events[1]),
                "launches": s.launches} for s in spans]
        if prof is not None:
            self._place_on_trace(out, prof)
        return out

    def _place_on_trace(self, records: List[dict], prof) -> None:
        start_ns = prof.profiler.kineto_results.trace_start_ns()
        calls = sorted(ev.time_range.start for ev in prof.events() if ev.name.startswith("cudaEventRecord"))
        for r in records:
            r["trace_us"], r["record_us"] = ([(t + self._unix_ns - start_ns) / 1e3 for t in r[key]]
                                             for key in ("host_ns", "record_ns"))
            r["anchor_us"] = [_own_call(calls, a, b) for a, b in zip(r["trace_us"], r["record_us"])] \
                if calls else None


def _own_call(starts: List[float], a: float, b: float) -> float:
    """The first of the sorted `starts` within [a, b], else the one nearest
    that bracket."""
    i = bisect.bisect_left(starts, a)
    if i < len(starts) and starts[i] <= b:
        return starts[i]
    return min(starts[max(i - 1, 0): i + 1], key=lambda v: max(a - v, v - b))
