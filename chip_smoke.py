#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card (H100) and check it.

    python3 chip_smoke.py             # the four phases below
    python3 chip_smoke.py --profile   # and a per-stage time breakdown of
                                      # one forward, written to chiprun_out/

Phases (any failure raises, and the exit code is not 0):

1. build   every `anystereo_tpu_torch/csrc/*.cu` with nvcc for sm_90a, all
           sources at once;
2. kernels each kernel against its plain PyTorch version on the card, at the
           shapes the main path gives it, with its time (CUDA events, L2
           flushed before each launch), the plain version's time and the
           least time the card could take for the same work;
3. model   the IGEV eval forward at its main-path configuration
           (`ModelConfig()`, 1x384x1248, 32 GRU iterations, bf16, weights
           from a seeded generator): one warm-up and three timed requests;
           every kernel's launch count is read over exactly these requests;
4. check   the same forward in fp32 (TF32 off) with 4 iterations, once
           through the kernels and once with the lookup forced to its plain
           version; the two disparities must agree.

It prints a `kernels` JSON line, the card's name and power limit as
nvidia-smi reports them, and last `{"ok": true, "device": {...}}`.  It
exits with code 2 and prints no result when no CUDA card is visible.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

H, W, ITERS = 384, 1248, 32
CHECK_ITERS = 4
TAPS, LEVELS = 9, 2
REQUESTS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOP_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
FP32_ATOL = 1e-5
MODEL_CHECK_ATOL = 1e-3  # px, fp32 forward, kernel vs plain lookup
OUT_DIR = "chiprun_out"
DEVICE = "cuda"


def _log(*a):
    print(*a, flush=True)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- phase 1


def phase_build():
    from anystereo_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    seconds = build.build()
    for name, log in build.BUILD_LOGS.items():
        _log(f"[build] {name}.cu ptxas:\n{log.strip()}")
    _log(f"[build] {sorted(seconds)} built in {time.perf_counter() - t0:.2f} s "
         f"(per source: {json.dumps({k: round(v, 2) for k, v in seconds.items()})})")


# ----------------------------------------------------------------- phase 2


def _time_ms(torch, fn, reps=20, warmup=3):
    """Median device time of `fn` by CUDA events, with a 256 MB write before
    each launch so the volumes are not left in the 50 MB L2 (in the GRU loop
    the update block runs between two lookups)."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=DEVICE)
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in ev)
    return times[len(times) // 2]


def _lookup_cost(torch, x, length, out_itemsize):
    """Bytes and fp32 operations the lookup needs for these positions: the
    volume elements inside some level's window (each read once), x, and the
    output (written once)."""
    radius = (TAPS - 1) // 2
    slack = (radius + 2) * 2 ** LEVELS
    xc = x.clamp(-slack, length + slack)
    j = torch.arange(length, device=x.device)
    need = torch.zeros((x.shape[0], length), dtype=torch.bool, device=x.device)
    flops = 0
    for lvl in range(LEVELS):
        width, n = 2 ** lvl, length >> lvl
        i0 = torch.floor(xc / width - radius).long()
        start = i0.clamp(0, n) * width
        end = (i0 + TAPS + 1).clamp(0, n) * width
        need |= (j >= start[:, None]) & (j < end[:, None])
        # 6 per tap (position, weight, two products, sum); pooling 2 per pair
        flops += x.shape[0] * (6 * TAPS + 2 * (width - 1) * (TAPS + 1))
    rows = x.shape[0]
    nbytes = 4 * int(need.sum()) + 4 * rows + out_itemsize * rows * LEVELS * TAPS
    return nbytes, flops


def _bf16_ulps_ok(torch, got, want):
    """|got - want| <= one bf16 spacing at want (both are bf16 roundings of
    fp32 results that agree to FP32_ATOL)."""
    g, w = got.float(), want.float()
    _, exp = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), exp - 8)
    return bool(((g - w).abs() <= torch.maximum(ulp, torch.full_like(w, FP32_ATOL))).all())


def phase_kernels(torch):
    from anystereo_tpu_torch.ops.kernels.lookup import (
        gather_pyramid_aligned,
        gather_pyramid_aligned_ref,
    )

    h4, w4, groups, d = H // 4, W // 4, 8, 192 // 4
    g = torch.Generator(device=DEVICE).manual_seed(0)
    calls = []
    for call, rows, length in (("gev", h4 * w4 * groups, d), ("corr", h4 * w4, w4)):
        vol = torch.randn(rows, length, device=DEVICE, generator=g)
        # the check: positions over the row and 20 past both ends, and a few
        # far outside [0, L) at both signs; the timing: positions inside the
        # row, as disparities (GEV) and matched columns (corr) mostly are
        x_main = torch.rand(rows, device=DEVICE, generator=g) * length
        x = torch.rand(rows, device=DEVICE, generator=g) * (length + 40) - 20
        far = torch.tensor([-1e6, 1e6, -3e4, 2.5e3, -60.0, length + 60.0], device=DEVICE)
        x[: far.numel()] = far
        res = {"call": call, "rows": rows, "length": length}
        for out_dtype in (torch.float32, torch.bfloat16):
            got = gather_pyramid_aligned(vol, x, TAPS, LEVELS, out_dtype)
            want = gather_pyramid_aligned_ref(vol, x, TAPS, LEVELS, out_dtype)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            name = "fp32" if out_dtype == torch.float32 else "bf16"
            if out_dtype == torch.float32:
                if not err <= FP32_ATOL:
                    raise AssertionError(f"{call} fp32: max |kernel - plain| {err} > {FP32_ATOL}")
                res["max_abs_err"] = err
            elif not _bf16_ulps_ok(torch, got, want):
                raise AssertionError(f"{call} bf16: kernel and plain differ by more than 1 ulp")
            res[f"max_abs_err_{name}"] = err
        # the main path asks for bf16 out
        res["ms"] = _time_ms(torch, lambda: gather_pyramid_aligned(
            vol, x_main, TAPS, LEVELS, torch.bfloat16))
        res["plain_ms"] = _time_ms(torch, lambda: gather_pyramid_aligned_ref(
            vol, x_main, TAPS, LEVELS, torch.bfloat16), reps=5)
        nbytes, flops = _lookup_cost(torch, x_main, length, 2)
        res["bytes"], res["flops"] = nbytes, flops
        res["bound_ms"] = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3
        res["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOP_PER_S \
            else "operations"
        _log(f"[kernels] gather_pyramid_aligned {call} R={rows} L={length}: "
             f"max|diff| fp32 {res['max_abs_err_fp32']:.3g} bf16 {res['max_abs_err_bf16']:.3g}; "
             f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
             f"bound {res['bound_ms']:.4f} ms ({nbytes} B)")
        del vol, x, x_main
        calls.append(res)
    return {
        "name": "gather_pyramid_aligned",
        "route": "cuda",
        "source": "anystereo_tpu_torch/csrc/lookup_aligned.cu",
        "replaces": "anystereo_tpu/ops/pallas/lookup_kernel.py:1103",
        # one GRU iteration's pair of calls (GEV then corr), bf16 out
        "ms": sum(c["ms"] for c in calls),
        "plain_ms": sum(c["plain_ms"] for c in calls),
        "bound_ms": sum(c["bound_ms"] for c in calls),
        "bound_by": "bytes" if all(c["bound_by"] == "bytes" for c in calls) else "operations",
        "max_abs_err": max(c["max_abs_err"] for c in calls),
        "library_ms": None,  # no single PyTorch call computes this lookup
        "per_call": calls,
    }


# ----------------------------------------------------------------- phase 3


def _images(torch, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    left = torch.rand(1, H, W, 3, device=DEVICE, generator=g) * 255
    # the right view is the left one shifted by 24 px, so the pair has a
    # consistent disparity for the volume to find
    right = torch.roll(left, shifts=-24, dims=2)
    return left, right


def phase_model(torch, kernels):
    from anystereo_tpu_torch.config import ModelConfig
    from anystereo_tpu_torch.nn.model import build_model

    model = build_model(ModelConfig(), device=DEVICE, seed=0)
    left, right = _images(torch, 1)
    for k in kernels:
        k.launches = 0
    times, per_forward = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + REQUESTS):
        before = [k.launches for k in kernels]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(left, right, iters=ITERS)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        if i:
            times.append(dt)
        per_forward.append([k.launches - b for k, b in zip(kernels, before)])
        disp = out.disp_final
        if tuple(disp.shape) != (1, H, W) or not bool(torch.isfinite(disp).all()):
            raise AssertionError(f"disp_final {tuple(disp.shape)} not finite [1, {H}, {W}]")
    launches = {k.__name__: k.launches for k in kernels}
    if any(n != [2 * ITERS] for n in per_forward):
        raise AssertionError(f"lookup launches per forward {per_forward}, want {2 * ITERS}")
    _log(f"[model] IGEV eval 1x{H}x{W}, {ITERS} iters, bf16: "
         f"{sum(times) / len(times):.2f} ms/pair over {REQUESTS} requests "
         f"({', '.join(f'{t:.2f}' for t in times)} ms; warm-up excluded), "
         f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
         f"disp_final range [{float(disp.min()):.3f}, {float(disp.max()):.3f}] px; "
         f"launches {launches}")
    return launches, model


# ----------------------------------------------------------------- phase 4


def phase_check(torch):
    from anystereo_tpu_torch.config import ModelConfig
    from anystereo_tpu_torch.nn.model import build_model
    from anystereo_tpu_torch.ops import lookup
    from anystereo_tpu_torch.ops.kernels.lookup import gather_pyramid_aligned_ref

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(ModelConfig(compute_dtype="float32"), device=DEVICE, seed=0)
    left, right = _images(torch, 1)
    kernel_out = model(left, right, iters=CHECK_ITERS)
    kernel_fn = lookup.gather_pyramid_aligned
    lookup.gather_pyramid_aligned = gather_pyramid_aligned_ref
    try:
        plain_out = model(left, right, iters=CHECK_ITERS)
    finally:
        lookup.gather_pyramid_aligned = kernel_fn
    torch.cuda.synchronize()
    diffs = {f: float((getattr(kernel_out, f) - getattr(plain_out, f)).abs().max())
             for f in ("init_disp", "disp_lowres", "disp_final")}
    _log(f"[check] fp32 forward, {CHECK_ITERS} iters, kernel vs plain lookup: "
         f"max |diff| {json.dumps(diffs)} (bound {MODEL_CHECK_ATOL} px)")
    if not all(d <= MODEL_CHECK_ATOL for d in diffs.values()):
        raise AssertionError(f"kernel and plain forwards disagree: {diffs}")


# ----------------------------------------------------------------- --profile


def phase_profile(torch, model):
    """Device time of each stage of one bf16 forward (CUDA events around
    the same calls `AnyStereo.forward` makes, in its order)."""
    from anystereo_tpu_torch.ops.coords import _axis_centers

    left, right = _images(torch, 1)
    stages = []

    def stage(name, fn):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        stages.append((name, s, e))
        return out

    with torch.no_grad():
        for _ in range(2):  # the second pass is the one kept
            stages.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scale = torch.ones((1,), device=DEVICE)
            ys, xs = _axis_centers(H, device=DEVICE), _axis_centers(W, device=DEVICE)
            l_, r_ = stage("normalize", lambda: (model._normalize(left), model._normalize(right)))
            ml, mr, fl, stems = stage("matching", lambda: model._matching(l_, r_))
            pyr, disp = stage("cost_stage", lambda: model._cost_stage(ml, mr, fl))
            net, ctx = stage("context", lambda: model._context(l_))
            for _ in range(ITERS):
                net, disp = stage("gru_iteration", lambda: model._gru_update(net, disp, pyr, ctx))
            stage("decode", lambda: model._upsample_dense(disp, net[0], stems, ys, xs, scale))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    totals = {}
    for name, s, e in stages:
        totals[name] = totals.get(name, 0.0) + s.elapsed_time(e)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(left, right, iters=ITERS)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    kernel_us, kernel_n = 0.0, 0
    for ev in averages:
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        if us > 0:
            kernel_us, kernel_n = kernel_us + us, kernel_n + ev.count
    summary = {"stages_ms": totals, "stages_wall_ms": wall, "forward_wall_ms": prof_wall,
               "kernel_ms": kernel_us / 1e3, "kernel_launches": kernel_n,
               "busy_share": kernel_us / 1e3 / prof_wall}
    table = averages.table(sort_by="cuda_time_total", row_limit=30)
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "profile_forward.txt")
    with open(path, "w") as f:
        f.write(json.dumps(summary) + "\n" + table)
    _log(f"[profile] {json.dumps(summary)}; kernel table in {path}")
    _log(table)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 2
    from anystereo_tpu_torch.ops.kernels.lookup import gather_pyramid_aligned

    kernels = [gather_pyramid_aligned]
    card = _card()
    _log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
         f"CUDA {torch.version.cuda}; nvidia-smi: {card}")
    phase_build()
    record = phase_kernels(torch)
    launches, model = phase_model(torch, kernels)
    record["launches"] = launches[record["name"]]
    if "--profile" in argv:
        phase_profile(torch, model)
    del model
    torch.cuda.empty_cache()
    phase_check(torch)
    if any(launches[k.__name__] == 0 for k in kernels):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
