"""What the traced run (`--trace 1`) records, from the benchmark's side of
the program: CUDA events around methods of the model instance, the
positions each lookup was called with, the kernels of a `torch.profiler`
trace, the device's busy time and the longest idle gaps."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch


class StageTimer:
    """Wraps methods of one model instance (an instance attribute shadows
    the class's method, so the program's own calls go through the wrapper)
    with a pair of CUDA events a call, while `active`.  A method the model
    no longer has is left out (its metric reads nothing).  Around
    `_gru_update(net, disp, pyr, ctx)` it also keeps the call's disparity
    and the shapes of its lookup pyramid."""

    def __init__(self, model: torch.nn.Module, names):
        self.active = False
        self.calls: Dict[str, List[list]] = {}  # name -> [per tick: [(start, end), ...]]
        self.lookups: List[list] = []  # per tick: [(disp, pyramid shapes) or None, ...]
        for name in names:
            fn = getattr(model, name, None)
            if callable(fn):
                self.calls[name] = []
                setattr(model, name, self._wrap(name, fn))

    def new_tick(self) -> None:
        for ticks in self.calls.values():
            ticks.append([])
        self.lookups.append([])

    def _wrap(self, name, fn):
        def timed(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.calls[name][-1].append((start, end))
            if name == "_gru_update":
                self.lookups[-1].append(_lookup_shapes(*args[1:3]))
            return out
        return timed

    def ms_per_tick(self, name: str) -> Optional[List[float]]:
        """Each traced tick's summed milliseconds of `name`, or None."""
        ticks = self.calls.get(name)
        if not ticks or not all(ticks):
            return None
        return [sum(s.elapsed_time(e) for s, e in calls) for calls in ticks]


def _lookup_shapes(disp, pyr):
    """(disparity [B, H, W], {"corr": L, "geo": (G, D) or None, "levels",
    "radius"}) of one lookup, or None where the pyramid has another form."""
    try:
        geo = None if pyr.geo is None else tuple(pyr.geo.shape[-2:])
        return disp.detach(), {"corr": int(pyr.corr.shape[-1]), "geo": geo,
                               "levels": int(pyr.num_levels), "radius": int(pyr.radius)}
    except AttributeError:
        return None


def _union_seconds(spans) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def reduce_profile(prof, top: int = 10) -> dict:
    """From a finished `torch.profiler.profile`: kernels by name ({name:
    [device ms, launches]}), `busy_s` (the union of every device activity's
    interval), the `top` device operations by time and the `top` longest
    idle gaps of the device, each named by the innermost host event of the
    trace (a CUDA runtime call) running at its start, or "no host
    operation" (Python between calls)."""
    from torch.autograd import DeviceType

    kernels: Dict[str, list] = {}
    device, host = [], []
    for ev in prof.events():
        span = (ev.time_range.start / 1e6, ev.time_range.end / 1e6)
        if ev.device_type == DeviceType.CUDA:
            device.append((span, ev.name))
            acc = kernels.setdefault(ev.name, [0.0, 0])
            acc[0] += (span[1] - span[0]) * 1e3
            acc[1] += 1
        else:
            host.append((span, ev.name))
    spans = sorted(s for s, _ in device)
    gaps = []
    end = spans[0][1] if spans else 0.0
    for s, e in spans[1:]:
        if s > end:
            gaps.append((s - end, end))
        end = max(end, e)
    gaps.sort(reverse=True)

    def host_at(t):
        live = [(e - s, name) for (s, e), name in host if s <= t < e]
        return min(live)[1] if live else "no host operation"

    return {
        "kernels": kernels,
        "busy_s": _union_seconds(spans),
        "device_ops": sorted(([k, v[0] / 1e3] for k, v in kernels.items()), key=lambda kv: -kv[1])[:top],
        "idle_gaps": [[host_at(t), g] for g, t in gaps[:top]],
    }


def kernel_ms(kernels: Dict[str, list], part: str) -> tuple:
    """(summed ms, launches) of the kernels whose names hold `part`."""
    hits = [v for name, v in kernels.items() if part in name]
    return sum(ms for ms, _ in hits), sum(n for _, n in hits)
