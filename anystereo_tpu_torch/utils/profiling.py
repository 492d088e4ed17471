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
"""

from __future__ import annotations

import contextlib
import dataclasses
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
