"""What every traffic generator (`stereo_bench/generators/<kind>.py`) shares:
the seeded weights of a configuration, the traced stretch of a window, and
a uniform sample of the window's answers for the check."""

from __future__ import annotations

import gc
import random
import subprocess
import sys
import time

import torch

from stereo_bench import program
from stereo_bench.cell import reference_module
from stereo_bench.trace import StageTimer, reduce_profile
from stereo_bench.weights import make_state_dict

TRACE_FROM, TRACE_TICKS = 2, 4  # the traced stretch: ticks 2..5 of the window

CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,temperature.gpu",
              "--format=csv,noheader"]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class TracedStretch:
    """Ticks TRACE_FROM .. TRACE_FROM + TRACE_TICKS - 1 of the window under
    `torch.profiler` (the device's activity only: host-side profiling
    doubles a tick's launch time), with the stage timer active, the
    kernels' launch counters read around them and `nvidia-smi` read beside
    them."""

    def __init__(self, model, stages):
        self.timer = StageTimer(model, stages)
        self.prof = None

    @staticmethod
    def covers(i: int) -> bool:
        return TRACE_FROM <= i < TRACE_FROM + TRACE_TICKS

    @staticmethod
    def wants(i: int) -> bool:
        """Whether the window has to run on to tick i to finish the stretch."""
        return i < TRACE_FROM + TRACE_TICKS

    def before(self, i: int) -> None:
        if i == TRACE_FROM:
            try:
                self.smi = subprocess.Popen(CARD_QUERY, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
            except OSError:
                self.smi = None
            self.launched = program.launches()
            self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.timer.active = True
            self.t0 = time.perf_counter()
        if self.timer.active:
            self.timer.new_tick()

    def after(self, i: int) -> None:
        if i == TRACE_FROM + TRACE_TICKS - 1:
            self.seconds = time.perf_counter() - self.t0
            self.timer.active = False
            self.prof.__exit__(None, None, None)
            self.launched = {n: c - self.launched[n] for n, c in program.launches().items()}
            self.card = "not read (no nvidia-smi)"
            if self.smi is not None:
                out = self.smi.communicate(timeout=60)[0].strip()
                self.card = out.splitlines()[0] if self.smi.returncode == 0 and out else "not read"

    def record(self, ticks, flops_per_tick: float, units: int, **extra) -> dict:
        """What the per-layer readers read."""
        untraced = [j for j in range(len(ticks)) if not self.covers(j)]
        return {"units_per_tick": units, "untraced_ticks": len(untraced),
                "untraced_s": sum(ticks[j][1] - ticks[j][0] for j in untraced),
                "flops_per_tick": flops_per_tick,
                "stage_ms": {name: self.timer.ms_per_tick(name) for name in self.timer.calls},
                "lookups": self.timer.lookups, "launches": self.launched, "compute_itemsize": 2,
                "traced_s": self.seconds, "traced_ticks": TRACE_TICKS, "card": self.card,
                **reduce_profile(self.prof), **extra}


def reservoir(rng: random.Random, kept: list, k: int, i: int, item) -> None:
    """Keep a uniform sample of k of the items seen (the i-th now)."""
    if len(kept) < k:
        kept.append(item)
    else:
        j = rng.randrange(i + 1)
        if j < k:
            kept[j] = item


def seeded_state(cfg: dict, seed: int, device):
    """(the configuration's reference module, the seeded state dict)."""
    reference = reference_module(cfg)
    with torch.device("meta"):
        shapes = reference.build(cfg["model"])
    return reference, make_state_dict(reference, shapes, seed, device, cfg.get("weight_gain"))


def release(on_card: bool) -> None:
    """Return what the program held to the allocator before the check."""
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
