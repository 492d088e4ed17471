#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card (H100) and check it.

    python3 chip_smoke.py             # the phases below
    python3 chip_smoke.py --profile   # and time breakdowns of one eval
                                      # forward and one training step,
                                      # written to chiprun_out/
    python3 chip_smoke.py --spread    # and the run-to-run spread of the fp32
                                      # gradients with and without cuDNN's
                                      # deterministic algorithms

Phases (any failure raises, and the exit code is not 0):

1. build   every `anystereo_tpu_torch/csrc/*.cu` with nvcc for sm_90a, all
           sources at once;
2. kernels each kernel against its plain PyTorch version on the card, at the
           shapes the main paths give it, with its time (CUDA events, L2
           flushed before each launch), the plain version's time, the time
           of the one PyTorch call that computes the same function (where
           there is one) and the least time the card could take: the pyramid
           lookup's forward (eval and training shapes) and backward
           (training shapes),
           the query row gather and its scatter-add transpose (the 9-tap
           disparity table and both latent tables, 51,200 queries a sample);
3. model   the IGEV eval forward at its main-path configuration
           (`ModelConfig()`, 1x384x1248, 32 GRU iterations, bf16, weights
           from a seeded generator): one warm-up and three timed requests;
           every kernel's launch count is read over exactly these requests;
4. train   the IGEV training step at full width (`ModelConfig()`,
           `TrainConfig()`: batch 2, 160x320, 51,200 queries a sample, 16
           iterations with a query decode each, bf16, sequence loss, clip,
           AdamW) on a seeded synthetic batch: one warm-up and three timed
           steps with the exact launch counts of each, then one forward and
           backward under the default gather dispatch and one with every
           query gather forced through the kernels, from the same state,
           and six more steps alternating the two dispatches, timed;
5. check   fp32 (TF32 off): the eval forward with 4 iterations through the
           kernels and with the lookup forced to its plain version; then a
           training loss and every parameter's gradient (batch 1, 4
           iterations, 4,096 queries) through the kernels and with every
           kernel forced to its plain version.

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
TRAIN_H, TRAIN_W, TRAIN_SHIFT = 160, 320, 6  # TrainConfig().inp_size, px of disparity
TRAIN_STEPS = 3
SCATTER_RTOL = 1e-5  # |kernel - plain| <= rtol * (1 + sum_q |g[q, c]| of that element): atomic order
GRAD_CHECK_RTOL, GRAD_CHECK_ATOL, LOSS_CHECK_RTOL = 1e-3, 1e-7, 1e-5
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
    the update block runs between two lookups).  64 such writes (~5 ms) are
    queued first, so the host runs ahead of the card and the events enclose
    the kernel, not the host's time in the wrapper."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=DEVICE)
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for _ in range(64):
        flush.zero_()
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


def _kernels_lookup_fwd(torch):
    from anystereo_tpu_torch.ops.kernels.lookup import (
        gather_pyramid_aligned,
        gather_pyramid_aligned_ref,
    )

    h4, w4, groups, d = H // 4, W // 4, 8, 192 // 4
    cells, tw4 = 2 * (TRAIN_H // 4) * (TRAIN_W // 4), TRAIN_W // 4
    g = torch.Generator(device=DEVICE).manual_seed(0)
    calls = []
    # the eval forward's pair of calls (batch 1, 96x312 cells), then the
    # training step's pair (batch 2, 40x80 cells)
    for call, rows, length in (("gev", h4 * w4 * groups, d), ("corr", h4 * w4, w4),
                               ("train_gev", cells * groups, d), ("train_corr", cells, tw4)):
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
        res["bound_ms"], res["bound_by"] = _bound(nbytes, flops)
        _log(f"[kernels] gather_pyramid_aligned {call} R={rows} L={length}: "
             f"max|diff| fp32 {res['max_abs_err_fp32']:.3g} bf16 {res['max_abs_err_bf16']:.3g}; "
             f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
             f"bound {res['bound_ms']:.4f} ms ({nbytes} B)")
        del vol, x, x_main
        calls.append(res)
    # the record's times are one eval GRU iteration's pair of calls (GEV then
    # corr), bf16 out; the training pair stands in `per_call`.  No single
    # PyTorch call computes this lookup
    return _record("gather_pyramid_aligned", "anystereo_tpu_torch/csrc/lookup_aligned.cu",
                   "anystereo_tpu/ops/pallas/lookup_kernel.py:1103", calls, main=(0, 1))


def _bound(nbytes, flops):
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def _record(name, source, replaces, calls, main, library=False):
    """One entry of the `kernels` line: the times are those of the calls the
    main path makes (`main`: indices into `calls`), summed."""
    picked = [calls[i] for i in main]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "ms": sum(c["ms"] for c in picked),
        "plain_ms": sum(c["plain_ms"] for c in picked),
        "bound_ms": sum(c["bound_ms"] for c in picked),
        "bound_by": "bytes" if all(c["bound_by"] == "bytes" for c in picked) else "operations",
        "max_abs_err": max(c["max_abs_err"] for c in calls),
        "library_ms": sum(c["library_ms"] for c in picked) if library else None,
        "per_call": calls,
    }


def _kernels_lookup_bwd(torch):
    """The lookup's backward at the two training shapes (batch 2, 40x80 cells:
    GEV rows of 48, correlation rows of 80), against its plain version.  The
    kernel repeats the plain version's operations in its order, so the two
    must agree exactly, with the cotangent in fp32 and in bf16."""
    from anystereo_tpu_torch.ops.kernels.lookup import (
        gather_pyramid_aligned_bwd,
        gather_pyramid_aligned_bwd_ref,
    )

    cells, groups = 2 * (TRAIN_H // 4) * (TRAIN_W // 4), 8
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    calls = []
    for call, rows, length in (("gev", cells * groups, 192 // 4), ("corr", cells, TRAIN_W // 4)):
        x_main = torch.rand(rows, device=DEVICE, generator=gen) * length
        x = torch.rand(rows, device=DEVICE, generator=gen) * (length + 40) - 20
        far = torch.tensor([-1e6, 1e6, -3e4, 2.5e3, -60.0, length + 60.0], device=DEVICE)
        x[: far.numel()] = far
        g32 = torch.randn(rows, LEVELS * TAPS, device=DEVICE, generator=gen)
        res = {"call": call, "rows": rows, "length": length}
        for g in (g32, g32.bfloat16()):
            got = gather_pyramid_aligned_bwd(x, g, length, TAPS, LEVELS)
            want = gather_pyramid_aligned_bwd_ref(x, g, length, TAPS, LEVELS)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if err != 0.0 or not bool((got[: far.numel() - 2] == 0).all()):
                raise AssertionError(f"lookup backward {call} {g.dtype}: max |kernel - plain| "
                                     f"{err}, want 0 (and zero rows for far positions)")
            res["max_abs_err"] = max(res.get("max_abs_err", 0.0), err)
        g = g32.bfloat16()  # the main path's cotangent is bf16
        res["ms"] = _time_ms(torch, lambda: gather_pyramid_aligned_bwd(x_main, g, length, TAPS, LEVELS))
        res["plain_ms"] = _time_ms(torch, lambda: gather_pyramid_aligned_bwd_ref(
            x_main, g, length, TAPS, LEVELS), reps=5)
        # g and x read once, the whole of dvol written once; per row a
        # product and a sum per tap side, a scale and a sum per entry and level
        res["bytes"] = rows * (LEVELS * TAPS * 2 + 4 + length * 4)
        res["flops"] = rows * LEVELS * (4 * TAPS + 2 * length)
        res["bound_ms"], res["bound_by"] = _bound(res["bytes"], res["flops"])
        _log(f"[kernels] gather_pyramid_aligned_bwd {call} R={rows} L={length}: max|diff| "
             f"{res['max_abs_err']:.3g}; kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
             f"bound {res['bound_ms']:.4f} ms ({res['bytes']} B)")
        calls.append(res)
    return _record("gather_pyramid_aligned_bwd", "anystereo_tpu_torch/csrc/lookup_aligned.cu",
                   "anystereo_tpu/ops/pallas/lookup_kernel.py:965", calls, main=(0, 1))


def _kernels_gather(torch):
    """The query row gather and its scatter-add transpose at the training
    tables: the 9-tap disparity rows (fp32) and the two latents (bf16), 51,200
    queries a sample drawn with duplicates.  The gather is a copy and must be
    exact.  The scatter sums with atomics, so a row's sum is taken in another
    order than the plain version's: for each (row, channel),
    |diff| <= 1e-5 * (1 + the sum of |g| over the queries that land there)."""
    from anystereo_tpu_torch.ops.kernels.gather import (
        gather_rows,
        gather_rows_ref,
        scatter_rows_add,
        scatter_rows_add_ref,
    )

    batch, q = 2, TRAIN_H * TRAIN_W
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    fwd, bwd = [], []
    for n, c, dtype in ((3200, 9, torch.float32), (3200, 184, torch.bfloat16),
                        (12800, 40, torch.bfloat16)):
        es = 4 if dtype == torch.float32 else 2
        table = torch.randn(batch, n, c, device=DEVICE, generator=gen).to(dtype)
        idx = torch.randint(0, n, (batch, q), device=DEVICE, generator=gen, dtype=torch.int32)
        g = torch.randn(batch, q, c, device=DEVICE, generator=gen).to(dtype)
        idx_long = idx.long()
        b_col = torch.arange(batch, device=DEVICE)[:, None]
        shape = {"table": [batch, n, c], "dtype": str(dtype).split(".")[-1], "queries": q}

        with torch.no_grad():
            got, want = gather_rows(table, idx), gather_rows_ref(table, idx)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"gather_rows {shape}: the kernel's rows differ from the table's")
            res = dict(shape, max_abs_err=0.0)
            res["ms"] = _time_ms(torch, lambda: gather_rows(table, idx))
            res["plain_ms"] = _time_ms(torch, lambda: gather_rows_ref(table, idx))
            res["library_ms"] = _time_ms(torch, lambda: table[b_col, idx_long])
        res["bytes"], res["flops"] = idx.numel() * 4 + table.numel() * es + got.numel() * es, 0
        res["bound_ms"], res["bound_by"] = _bound(res["bytes"], 0)
        _log(f"[kernels] gather_rows {shape}: exact; kernel {res['ms']:.4f} ms, plain "
             f"{res['plain_ms']:.4f} ms, indexing {res['library_ms']:.4f} ms, bound "
             f"{res['bound_ms']:.4f} ms ({res['bytes']} B)")
        fwd.append(res)

        got, want = scatter_rows_add(idx, g, n), scatter_rows_add_ref(idx, g, n)
        row_abs = scatter_rows_add_ref(idx, g.abs(), n)  # per element: sum over its queries
        torch.cuda.synchronize()
        diff = (got - want).abs()
        if not bool((diff <= SCATTER_RTOL * (1.0 + row_abs)).all()):
            raise AssertionError(f"scatter_rows_add {shape}: max |kernel - plain| {float(diff.max())}")
        res = dict(shape, max_abs_err=float(diff.max()))
        res["ms"] = _time_ms(torch, lambda: scatter_rows_add(idx, g, n))
        res["plain_ms"] = _time_ms(torch, lambda: scatter_rows_add_ref(idx, g, n))
        # the library call: one fp32 index_add_ over the flattened batch (its
        # fp32 source and int64 index are prepared outside the timing)
        g32 = g.float().reshape(batch * q, c)
        flat = (idx_long + b_col * n).reshape(-1)
        out = torch.empty(batch * n, c, device=DEVICE)
        res["library_ms"] = _time_ms(torch, lambda: out.zero_().index_add_(0, flat, g32))
        torch.cuda.synchronize()
        if not bool(((out.view_as(want) - want).abs() <= SCATTER_RTOL * (1.0 + row_abs)).all()):
            raise AssertionError(f"index_add_ {shape} disagrees with the plain version")
        res["bytes"], res["flops"] = idx.numel() * 4 + g.numel() * es + got.numel() * 4, g.numel()
        res["bound_ms"], res["bound_by"] = _bound(res["bytes"], res["flops"])
        _log(f"[kernels] scatter_rows_add {shape}: max|diff| {res['max_abs_err']:.3g}; kernel "
             f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, index_add_ "
             f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bytes']} B)")
        bwd.append(res)
        del table, idx, g, got, want, out, g32
    src = "anystereo_tpu_torch/csrc/gather_rows.cu"
    # per decode: the default dispatch sends the 9-tap table's backward to the
    # scatter; forcing the kernels sends all three tables both ways
    return [
        _record("gather_rows", src, "anystereo_tpu/ops/pallas/gather_kernel.py:319", fwd,
                main=(0, 1, 2), library=True),
        _record("scatter_rows_add", src, "anystereo_tpu/ops/pallas/gather_kernel.py:355", bwd,
                main=(0,), library=True),
    ]


def phase_kernels(torch):
    return [_kernels_lookup_fwd(torch), _kernels_lookup_bwd(torch), *_kernels_gather(torch)]


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
    want = [2 * ITERS if k.__name__ == "gather_pyramid_aligned" else 0 for k in kernels]
    if any(n != want for n in per_forward):
        raise AssertionError(f"launches per forward {per_forward}, want {want}")
    _log(f"[model] IGEV eval 1x{H}x{W}, {ITERS} iters, bf16: "
         f"{sum(times) / len(times):.2f} ms/pair over {REQUESTS} requests "
         f"({', '.join(f'{t:.2f}' for t in times)} ms; warm-up excluded), "
         f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
         f"disp_final range [{float(disp.min()):.3f}, {float(disp.max()):.3f}] px; "
         f"launches {launches}")
    return launches, model


# ----------------------------------------------------------------- phase 4


def _train_batch(torch, batch, h, w, q, seed):
    """A synthetic batch on the card: the right view is the left one shifted
    by TRAIN_SHIFT px, the queries are uniform in (-1, 1) and the ground truth
    is that shift as seen at the queried resolution (shift * scale)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    left = torch.rand(batch, h, w, 3, device=DEVICE, generator=gen) * 255
    scale = torch.linspace(1.5, 2.5, batch, device=DEVICE) if batch > 1 else \
        torch.full((1,), 1.5, device=DEVICE)
    return {
        "left": left,
        "right": torch.roll(left, shifts=-TRAIN_SHIFT, dims=2),
        "coords": torch.rand(batch, q, 2, device=DEVICE, generator=gen) * 2 - 1,
        "scale": scale,
        "gt": (TRAIN_SHIFT * scale)[:, None].expand(batch, q).contiguous(),
        "valid": torch.ones(batch, q, device=DEVICE),
        "gt_low": torch.full((batch, h // 4, w // 4), TRAIN_SHIFT / 4.0, device=DEVICE),
    }


def _counts(kernels):
    return [k.launches for k in kernels]


def _expect_launches(kernels, before, want, what):
    got = {k.__name__: k.launches - b for k, b in zip(kernels, before)}
    if got != want:
        raise AssertionError(f"kernel launches of {what}: {got}, want {want}")


def phase_train(torch, kernels):
    from anystereo_tpu_torch.config import ModelConfig, TrainConfig
    from anystereo_tpu_torch.nn.model import build_model
    from anystereo_tpu_torch.ops.sampling import set_gather_override
    from anystereo_tpu_torch.train.state import create_train_state
    from anystereo_tpu_torch.train.step import loss_and_metrics, make_train_step

    tcfg = TrainConfig()
    model = build_model(ModelConfig(), device=DEVICE, seed=0)
    state = create_train_state(model, tcfg)
    step = make_train_step(model, tcfg)
    batch = _train_batch(torch, tcfg.batch_size, TRAIN_H, TRAIN_W, tcfg.sample_q, seed=4)
    it = tcfg.train_iters
    per_step = {"gather_pyramid_aligned": 2 * it, "gather_pyramid_aligned_bwd": 2 * it,
                "gather_rows": 0, "scatter_rows_add": it}
    forced = dict(per_step, gather_rows=3 * it, scatter_rows_add=3 * it)
    for k in kernels:
        k.launches = 0
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    times, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + TRAIN_STEPS):
        before = _counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        if i:
            times.append(dt)
        _expect_launches(kernels, before, per_step, f"training step {i}")
        loss, gnorm = float(metrics["loss"]), metrics["grad_norm"]
        losses.append(loss)
        if not (loss == loss and abs(loss) != float("inf") and 0 < gnorm < float("inf")):
            raise AssertionError(f"step {i}: loss {loss}, grad_norm {gnorm}")
        if metrics["nonfinite_skips"] != 0 or state.total_notfinite != 0:
            raise AssertionError(f"step {i} was skipped for non-finite gradients")
        grads = {n: p.grad for n, p in model.named_parameters()}
        bad = [n for n, g in grads.items() if g is None or not bool(torch.isfinite(g).all())]
        if bad:
            raise AssertionError(f"step {i}: parameters without a finite gradient: {bad}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    zero = [n for n, g in grads.items() if not bool(g.any())]
    still = [n for n, p in model.named_parameters()
             if n not in zero and torch.equal(p.detach(), start[n])]
    if still:
        raise AssertionError(f"parameters with a gradient that did not change: {still}")
    _log(f"[train] IGEV training step {tcfg.batch_size}x{TRAIN_H}x{TRAIN_W}, Q {tcfg.sample_q}, "
         f"{it} iters, bf16: {sum(times) / len(times):.2f} ms/step over {TRAIN_STEPS} steps "
         f"({', '.join(f'{t:.2f}' for t in times)} ms; warm-up excluded), peak {peak:.2f} GiB; "
         f"losses {[round(v, 4) for v in losses]}; last grad_norm {gnorm:.3f}, lr "
         f"{metrics['lr']:.3e}, epe {float(metrics['epe']):.3f} px; launches per step {per_step}; "
         f"parameters with an exactly zero gradient: {zero}")

    # one forward and backward under each dispatch, from the same state: with
    # the kernels forced, the three query gathers of every decode launch the
    # gather kernel forward and the scatter kernel backward
    pair = []
    for impl, want in ((None, per_step), ("kernel", forced)):
        set_gather_override(impl)
        try:
            before = _counts(kernels)
            state.optimizer.zero_grad()
            loss, _ = loss_and_metrics(model, tcfg, batch)
            loss.backward()
            torch.cuda.synchronize()
        finally:
            set_gather_override(None)
        _expect_launches(kernels, before, want, f"forward+backward, gather override {impl!r}")
        pair.append(float(loss.detach()))
    rel = abs(pair[0] - pair[1]) / abs(pair[0])
    _log(f"[train] loss under the default dispatch {pair[0]:.6f}, with the gather kernels forced "
         f"{pair[1]:.6f} (relative difference {rel:.2e}, bound 1e-3); launches when forced {forced}")
    if not rel <= 1e-3:
        raise AssertionError(f"forcing the gather kernels changed the loss: {pair}")
    # whole steps under each dispatch, alternated within this run (the host's
    # speed differs between runs): does sending every table to the kernels
    # show end to end?
    by_impl = {None: [], "kernel": []}
    for impl in (None, "kernel", "kernel", None, None, "kernel"):
        set_gather_override(impl)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            by_impl[impl].append((time.perf_counter() - t0) * 1e3)
        finally:
            set_gather_override(None)
        if metrics["nonfinite_skips"] != 0:
            raise AssertionError(f"a step under gather override {impl!r} was skipped")
    _log("[train] ms/step alternating the dispatch: default "
         f"{[round(t, 2) for t in by_impl[None]]}, every table through the gather kernels "
         f"{[round(t, 2) for t in by_impl['kernel']]}")
    launches = {k.__name__: k.launches for k in kernels}
    return launches, (model, tcfg, state, step, batch)


# ----------------------------------------------------------------- phase 5


def _check_eval(torch):
    from anystereo_tpu_torch.config import ModelConfig
    from anystereo_tpu_torch.nn.model import build_model
    from anystereo_tpu_torch.ops import lookup
    from anystereo_tpu_torch.ops.kernels.lookup import gather_pyramid_aligned_ref

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


def _fp32_train_runs(torch):
    """Two closures over one fp32 model and batch (batch 1, 4 iterations,
    4,096 queries): the training loss and every parameter's gradient through
    the kernels, and the same with every kernel forced to its plain version
    (the lookup to `gather_pyramid_aligned_ref` under PyTorch's own autograd,
    the query gathers to plain indexing)."""
    from anystereo_tpu_torch.config import ModelConfig, TrainConfig
    from anystereo_tpu_torch.nn.model import build_model
    from anystereo_tpu_torch.ops import lookup
    from anystereo_tpu_torch.ops.kernels.lookup import gather_pyramid_aligned_ref
    from anystereo_tpu_torch.ops.sampling import set_gather_override
    from anystereo_tpu_torch.train.step import loss_and_metrics

    tcfg = TrainConfig(train_iters=CHECK_ITERS)
    model = build_model(ModelConfig(compute_dtype="float32"), device=DEVICE, seed=0)
    batch = _train_batch(torch, 1, TRAIN_H, TRAIN_W, 4096, seed=5)

    def through_kernels():
        for p in model.parameters():
            p.grad = None
        loss, _ = loss_and_metrics(model, tcfg, batch)
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}

    def plain():
        kernel_fn = lookup.gather_pyramid_aligned
        lookup.gather_pyramid_aligned = gather_pyramid_aligned_ref
        set_gather_override("torch")
        try:
            return through_kernels()
        finally:
            lookup.gather_pyramid_aligned = kernel_fn
            set_gather_override(None)

    return through_kernels, plain


def _grad_diff(got, want):
    """(worst ||dg|| / ||g||, its parameter, the parameters past the bound)."""
    worst, worst_name, bad = 0.0, None, []
    for name, g in want.items():
        if g is None or got[name] is None:  # not reached by the loss: on both sides
            if g is not got[name]:
                bad.append((name, "reached on one side only"))
            continue
        delta, norm = float((got[name] - g).norm()), float(g.norm())
        if norm > 0 and delta / norm > worst:
            worst, worst_name = delta / norm, name
        if not delta <= GRAD_CHECK_RTOL * norm + GRAD_CHECK_ATOL:
            bad.append((name, delta, norm))
    return worst, worst_name, bad


def _check_train(torch):
    """fp32 training loss and gradients through the kernels against the same
    with every kernel forced to its plain version."""
    through_kernels, plain = _fp32_train_runs(torch)
    k_loss, k_grads = through_kernels()
    p_loss, p_grads = plain()
    worst, worst_name, bad = _grad_diff(k_grads, p_grads)
    rel = abs(k_loss - p_loss) / abs(p_loss)
    _log(f"[check] fp32 training loss and gradients, {CHECK_ITERS} iters, kernels vs plain: loss "
         f"{k_loss:.6f} vs {p_loss:.6f} (relative {rel:.2e}, bound {LOSS_CHECK_RTOL}); worst "
         f"||dg||/||g|| {worst:.2e} ({worst_name}) over {len(p_grads)} parameters "
         f"(bound {GRAD_CHECK_RTOL})")
    if not rel <= LOSS_CHECK_RTOL or bad:
        raise AssertionError(f"kernel and plain training disagree: loss {k_loss} vs {p_loss}; {bad}")


def phase_spread(torch):
    """--spread: how far two runs of one and the same fp32 path differ in
    their gradients, with cuDNN free to pick its algorithms and held to the
    deterministic ones.  It is why `phase_check` holds cuDNN: nothing is
    asserted here."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    through_kernels, plain = _fp32_train_runs(torch)
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        worst = {"plain vs plain": (0.0, None), "kernels vs kernels": (0.0, None),
                 "kernels vs plain": (0.0, None)}
        for _ in range(3):
            p1, p2, k1, k2 = plain()[1], plain()[1], through_kernels()[1], through_kernels()[1]
            for what, (a, b) in (("plain vs plain", (p2, p1)), ("kernels vs kernels", (k2, k1)),
                                 ("kernels vs plain", (k1, p1))):
                worst[what] = max(worst[what], _grad_diff(a, b)[:2], key=lambda w: w[0])
        _log(f"[spread] cudnn.deterministic {deterministic}: worst ||dg||/||g|| over 3 pairs of "
             f"runs: " + "; ".join(f"{k} {v[0]:.2e} ({v[1]})" for k, v in worst.items()))


def phase_check(torch):
    """fp32 without TF32, and cuDNN held to its deterministic algorithms: its
    other backward algorithms sum with atomics, and two runs of one and the
    same path then differ by up to 1e-2 relative in the cost aggregation's
    gradients (measured on the H100), which would hide the kernels' 5e-6."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    _check_eval(torch)
    _check_train(torch)


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
    prof_wall, kernel_ms, kernel_n, table = _profiled(
        torch, lambda: model(left, right, iters=ITERS))
    summary = {"stages_ms": totals, "stages_wall_ms": wall, "forward_wall_ms": prof_wall,
               "kernel_ms": kernel_ms, "kernel_launches": kernel_n,
               "busy_share": kernel_ms / prof_wall}
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "profile_forward.txt")
    with open(path, "w") as f:
        f.write(json.dumps(summary) + "\n" + table)
    _log(f"[profile] {json.dumps(summary)}; kernel table in {path}")
    _log(table)


def _profiled(torch, fn):
    """Run `fn` under torch.profiler: (wall ms, summed kernel ms, kernel
    launches, the table of kernels by device time)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    kernel_us, kernel_n = 0.0, 0
    for ev in averages:
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        if us > 0:
            kernel_us, kernel_n = kernel_us + us, kernel_n + ev.count
    return wall, kernel_us / 1e3, kernel_n, averages.table(sort_by="cuda_time_total", row_limit=40)


def phase_profile_train(torch, model, tcfg, state, step, batch):
    """Stream time of the forward, the backward and the optimizer of one
    training step (CUDA events), then the whole step under torch.profiler."""
    from anystereo_tpu_torch.train.step import loss_and_metrics

    def ev():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    for _ in range(2):  # the second pass is the one kept
        state.optimizer.zero_grad()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0 = ev()
        loss, _ = loss_and_metrics(model, tcfg, batch)
        e1 = ev()
        loss.backward()
        e2 = ev()
        state.optimizer.step()
        e3 = ev()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    stages = {"forward": e0.elapsed_time(e1), "backward": e1.elapsed_time(e2),
              "optimizer": e2.elapsed_time(e3)}
    prof_wall, kernel_ms, kernel_n, table = _profiled(torch, lambda: step(state, batch))
    summary = {"stages_ms": stages, "stages_wall_ms": wall, "step_wall_ms": prof_wall,
               "kernel_ms": kernel_ms, "kernel_launches": kernel_n,
               "busy_share": kernel_ms / prof_wall}
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "profile_train.txt")
    with open(path, "w") as f:
        f.write(json.dumps(summary) + "\n" + table)
    _log(f"[profile] training step: {json.dumps(summary)}; kernel table in {path}")
    _log(table)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 2
    from anystereo_tpu_torch.ops.kernels.gather import gather_rows, scatter_rows_add
    from anystereo_tpu_torch.ops.kernels.lookup import (
        gather_pyramid_aligned,
        gather_pyramid_aligned_bwd,
    )

    kernels = [gather_pyramid_aligned, gather_pyramid_aligned_bwd, gather_rows, scatter_rows_add]
    profile = "--profile" in argv
    card = _card()
    _log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
         f"CUDA {torch.version.cuda}; nvidia-smi: {card}")
    phase_build()
    records = phase_kernels(torch)
    eval_launches, model = phase_model(torch, kernels)
    if profile:
        phase_profile(torch, model)
    del model
    torch.cuda.empty_cache()
    train_launches, trained = phase_train(torch, kernels)
    if profile:
        phase_profile_train(torch, *trained)
    del trained
    torch.cuda.empty_cache()
    phase_check(torch)
    if "--spread" in argv:
        phase_spread(torch)
    for record in records:
        name = record["name"]
        record["launches_eval"], record["launches_train"] = eval_launches[name], train_launches[name]
        record["launches"] = eval_launches[name] + train_launches[name]
        if record["launches"] == 0:
            raise AssertionError(f"{name} never launched on a main path: "
                                 f"{eval_launches}, {train_launches}")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
