"""Traffic kind `eval_ticks`: a closed loop of ticks, each a batch of
rectified pairs through the program's eval step; the next tick is
dispatched when the previous one's disparities are on the host.

The mix's keys: `batch`, `height`, `width` (the pairs of a tick), `iters`
(GRU iterations), `disp_min`, `disp_max` (the scenes' disparity range in
input pixels), `distinct_ticks` (the seeded ticks the window cycles
through), `warmup_ticks`, `checked_ticks` (the window's ticks sampled for
the check), and two optional ones:

- `scale`: the output scale, one factor for every pair (default 1): the
  disparity is given in pixels of a frame `scale` times the input's size;
- `queries`: where the decode answers. "dense" (the default): the
  program's dense decode at the input's pixel centres (`coords` None).
  "grid": every pixel centre of the output frame, round(height * scale) x
  round(width * scale), as queries. A whole number n: n queries a pair,
  uniform over the frame, drawn from the seed.
"""

from __future__ import annotations

import random
import time
from typing import List

import torch

from stereo_bench import check, program, scenes, window
from stereo_bench.cell import Cell
from stereo_bench.harness import TracedStretch, log, release, reservoir, seeded_state
from stereo_bench.window import SetupClock

STAGES = ("_gru_update", "_upsample_dense", "_upsample")


def _centres(n: int, device) -> torch.Tensor:
    return -1.0 + (2.0 * torch.arange(n, dtype=torch.float32, device=device) + 1.0) / n


def inputs(tr: dict, seed: int, device):
    """(left, right, coords, scale, order): the mix's distinct ticks of
    pairs, [ticks, batch, H, W, 3] each; the queries of each tick
    ([ticks, batch, Q, 2] normalised (y, x), or None for the dense decode);
    the scale [batch]; the seeded order the window cycles through the ticks
    in."""
    n, b, h, w = tr["distinct_ticks"], tr["batch"], tr["height"], tr["width"]
    left, right, _ = scenes.stereo_pairs(n * b, h, w, tr["disp_min"], tr["disp_max"], seed + 1, device)
    s = float(tr.get("scale", 1.0))
    queries = tr.get("queries", "dense")
    coords = None
    if queries == "grid":
        ys, xs = _centres(round(h * s), device), _centres(round(w * s), device)
        grid = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), -1).reshape(-1, 2)
        coords = grid.expand(n, b, *grid.shape)
    elif queries != "dense":
        gen = torch.Generator(device=device).manual_seed(int(seed) + 3)
        coords = 2.0 * torch.rand((n, b, int(queries), 2), generator=gen, device=device) - 1.0
    order = list(range(n))
    random.Random(seed).shuffle(order)
    scale = torch.full((b,), s, device=device)
    return left.view(n, b, h, w, 3), right.view(n, b, h, w, 3), coords, scale, order


def _at(coords, k):
    return None if coords is None else coords[k]


def run(cell: Cell, seed: int, seconds: float, trace: bool, clock: SetupClock, device: str = "cuda") -> dict:
    tr, cfg = cell.traffic, cell.config
    b, h, w, iters = tr["batch"], tr["height"], tr["width"], tr["iters"]
    on_card = device == "cuda"
    clock.mark("program_import_s")
    if on_card:
        program.build_kernels()
    clock.mark("kernel_build_s")
    reference, state = seeded_state(cfg, seed, device)
    model = program.build_model(cfg, state, device)
    step = program.make_eval_step(model, valid_iters=iters, device=device)
    clock.mark("weights_s")
    left, right, coords, scale, order = inputs(tr, seed, device)
    n_ticks = len(order)
    clock.mark("inputs_s")
    for i in range(tr["warmup_ticks"]):
        k = order[i % n_ticks]
        step(left[k], right[k], _at(coords, k), scale).cpu()
    traced = TracedStretch(model, STAGES) if trace else None
    clock.mark("warmup_s")

    rng, kept = random.Random(seed), []
    ticks: List[window.Tick] = []
    enqueue_s: List[float] = []
    t_start = time.perf_counter()
    i = 0
    while time.perf_counter() - t_start < seconds or (traced and traced.wants(i)):
        if traced:
            traced.before(i)
        k = order[i % n_ticks]
        t0 = time.perf_counter()
        out = step(left[k], right[k], _at(coords, k), scale)
        t1 = time.perf_counter()
        host = out.cpu()
        t2 = time.perf_counter()
        if traced:
            traced.after(i)
        ticks.append((t0, t2, b))
        enqueue_s.append(t1 - t0)
        reservoir(rng, kept, tr["checked_ticks"], i, (i, k, host))
        i += 1
    result = {"ticks": ticks, "attempted": len(ticks) * b}
    result["peak_bytes"] = torch.cuda.max_memory_allocated() if on_card else 0
    if trace:
        from stereo_bench.reference.flops import eval_flops

        queries = None if coords is None else coords.shape[2]
        result["record"] = traced.record(
            ticks, eval_flops(reference, cfg["model"], b, h, w, iters, queries), b, chips=1,
            enqueue_ms=[1e3 * enqueue_s[j] for j in range(len(ticks)) if not traced.covers(j)])
    del step, model, traced
    release(on_card)
    result.update(_check(cell, state, left, right, coords, scale, kept, device))
    return result


def _check(cell: Cell, state, left, right, coords, scale, kept, device) -> dict:
    """The sampled ticks' answers against the fp32 reference's on the same
    inputs and weights."""
    t = time.perf_counter()
    ref = _reference(cell, state, device)
    readings = []
    with torch.no_grad():
        for _, k, host in kept:
            want = ref(left[k], right[k], cell.traffic["iters"], scale, coords=_at(coords, k)).cpu()
            readings += [check.disparity_gaps(p, r) for p, r in zip(host, want)]
    numbers = check.worst(readings)
    ok, checks = check.judge(numbers, cell.limits)
    failed = sum(1 for r in readings if any(r[n] > lim for n, lim in cell.limits.items()))
    log(f"[check] {len(kept)} ticks ({[i for i, _, _ in kept]}) against the reference in "
        f"{time.perf_counter() - t:.1f} s; worst over their pairs {numbers}")
    return {"correct": ok, "checks": checks, "failed": failed, "numbers": numbers, "readings": readings}


def _reference(cell: Cell, state, device, quant=None):
    from stereo_bench.cell import reference_module

    reference = reference_module(cell.config)
    reference.set_plain_float32()
    ref = reference.build(cell.config["model"], quant=quant).to(device)
    ref.load_state_dict(state, strict=True)
    return ref


def control(cell: Cell, seed: int, device: str = "cuda") -> tuple:
    """(worst gaps, every pair's gaps) of the reference computed in float8
    (`fp8_round`) from the fp32 reference, over the pairs of the first
    `checked_ticks` ticks of the seeded order: the control in the
    program's place."""
    tr = cell.traffic
    reference, state = seeded_state(cell.config, seed, device)
    left, right, coords, scale, order = inputs(tr, seed, device)
    exact = _reference(cell, state, device)
    low = _reference(cell, state, device, quant=reference.fp8_round)
    readings = []
    with torch.no_grad():
        for k in order[: tr["checked_ticks"]]:
            want = exact(left[k], right[k], tr["iters"], scale, coords=_at(coords, k)).cpu()
            got = low(left[k], right[k], tr["iters"], scale, coords=_at(coords, k)).cpu()
            readings += [check.disparity_gaps(g, r) for g, r in zip(got, want)]
    return check.worst(readings), readings
