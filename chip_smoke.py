#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card (H100) and check it.

    python3 chip_smoke.py             # the phases below
    python3 chip_smoke.py --profile   # and time breakdowns of one eval
                                      # forward and one training step,
                                      # written to chiprun_out/, with the
                                      # aligned lookup's forward summed
                                      # inside them
    python3 chip_smoke.py --spread    # and the run-to-run spread of the fp32
                                      # gradients with and without cuDNN's
                                      # deterministic algorithms
    python3 chip_smoke.py --parent DIR
                                      # and, in the kernels phase, the aligned
                                      # lookup's forward and the scatter-add
                                      # as the checkout at DIR builds them
                                      # (an earlier commit): held to this
                                      # tree's (the lookup bit for bit) and
                                      # timed beside them, in turns (with
                                      # --profile also inside the paths)

Phases (any failure raises, and the exit code is not 0):

1. build   every `anystereo_tpu_torch/csrc/*.cu` with nvcc for sm_90a, all
           sources at once;
2. kernels each kernel against its plain PyTorch version on the card, at the
           shapes the main paths give it, with its time (CUDA events, L2
           flushed before each launch), the plain version's time, the time
           of the one PyTorch call that computes the same function (where
           there is one) and the least time the card could take: the aligned
           pyramid lookup's forward and backward (IGEV shapes at 2 levels,
           RAFT shapes at 4), the window-pyramid lookups in their three
           layouts, forward and backward, held to their plain versions bit
           for bit and to each other, the query row gather and its
           scatter-add transpose (the 9-tap disparity table and both latent
           tables, 51,200 queries a sample), `gather_rows_hybrid`, and the
           single-level linear lookups, forward and backward, bit for bit:
           `gather_window_linear` at the eight level shapes of the "levels"
           flavor's eval forwards and the four of its training step,
           `gather_rows_linear` at the evaluator's occlusion shape
           (375 rows of 1242 positions) and at 300 x 312 x 9.  The aligned
           lookup's forward is held and timed at uniformly random positions
           and at path-shaped ones (a smooth disparity field), beside a
           PyTorch copy of as many bytes as its bound counts; it and the
           scatter-add carry `floor_ms`, the same wrapper's time on one row or
           one query;
3. model   the eval forward at full width, 1x384x1248, 32 GRU iterations,
           bf16, weights from a seeded generator, one warm-up and three timed
           requests each: the IGEV model (`ModelConfig()`), the RAFT model
           (`raft_config()`) under the "aligned" lookup flavor and under
           "classify", and both models under "levels" (path `eval_levels`);
           every kernel's launch count is read over exactly these requests;
4. validate `validate_dataset` on a seeded in-memory dataset of three
           375x1242 frames with left and right ground truth (IGEV model, 32
           iterations, bf16, padded to 384x1248 by the evaluator, the
           left-right occlusion split), then `Validator.infer` with
           `fixed_upscale=2` on a 188x624 pair and with `scale_test=2.0` on a
           375x1242 pair; ms per frame and the host's share of it;
5. train   the training step at full width (`TrainConfig()`: batch 2,
           160x320, 51,200 queries a sample, 16 iterations with a query decode
           each, bf16, sequence loss, clip, AdamW) on a seeded synthetic
           batch, one warm-up and three timed steps with the exact launch
           counts of each: the IGEV model ("aligned") and the RAFT model
           ("classify"); one timed step of the IGEV model under "levels";
6. check   fp32 (TF32 off, cuDNN deterministic), 4 iterations: the IGEV and
           RAFT eval forwards through the kernels against the same with every
           lookup forced to its plain version, under each flavor, and the
           flavors against "aligned"; the occlusion mask through the kernel
           against its plain version; a training loss and every parameter's
           gradient (batch 1, 4,096 queries) through the kernels and with
           every kernel forced to its plain version, IGEV under "aligned" and
           under "levels", RAFT under "classify"; one forward each with
           `quarter_nearest="both"` and with `local_ensemble=True`.

It prints a `kernels` JSON line, with `--parent` a short line of the
aligned lookup's and the scatter-add's times beside the parent's, the
card's name and power limit as nvidia-smi reports them, and last
`{"ok": true, "device": {...}}`.  It
exits with code 2 and prints no result when no CUDA card is visible.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

H, W, ITERS = 384, 1248, 32
CHECK_ITERS = 4
TAPS = 9
IGEV_LEVELS, RAFT_LEVELS = 2, 4  # ModelConfig().corr_levels, raft_config().corr_levels
FAR = (-1e6, 1e6, -3e4, 2.5e3)  # level-0 positions far outside any row
REQUESTS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOP_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
FP32_ATOL = 1e-5
MODEL_CHECK_ATOL = 1e-3  # px, fp32 forward, kernel vs plain lookup
TRAIN_BATCH, TRAIN_H, TRAIN_W, TRAIN_SHIFT = 2, 160, 320, 6  # TrainConfig(): batch, inp_size; px of disparity
TRAIN_STEPS = 3
EVAL_H, EVAL_W, EVAL_FRAMES = 375, 1242, 3  # KITTI-sized frames of the validate path
SCATTER_RTOL = 1e-5  # |kernel - plain| <= rtol * (1 + sum_q |g[q, c]| of that element): atomic order
GRAD_CHECK_RTOL, GRAD_CHECK_ATOL, LOSS_CHECK_RTOL = 1e-3, 1e-7, 1e-5
OUT_DIR = "chiprun_out"
DEVICE = "cuda"
PARENT = {}  # --parent: C entry points built from an earlier checkout's sources
PAIR_MS = {}  # (core, flavor) -> mean ms per pair of the timed eval requests
IN_PATH = {}  # --profile: B1's forward summed inside the profiled forward and step


def _log(*a):
    print(*a, flush=True)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- phase 1


def phase_build(parent=None):
    """Every source of this tree, and with `parent` (a checkout's root) that
    checkout's aligned lookup and row gather sources, all at once."""
    from anystereo_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    procs = []
    for name in ("lookup_aligned", "gather_rows") if parent else ():
        out = build.BUILD_DIR / f"libparent_{name}.so"
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = os.path.join(parent, "anystereo_tpu_torch", "csrc", f"{name}.cu")
        procs.append((name, out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    seconds = build.build()
    for name, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n{log}")
        PARENT[name] = _parent_entry(out, name)
    for name, log in build.BUILD_LOGS.items():
        _log(f"[build] {name}.cu ptxas:\n{log.strip()}")
    _log(f"[build] {sorted(seconds)} built in {time.perf_counter() - t0:.2f} s "
         f"(per source: {json.dumps({k: round(v, 2) for k, v in seconds.items()})})")


def _parent_entry(path, name):
    """The parent's C entry point: the lookup's forward has this tree's
    signature, the scatter the one it had before it took `vec`."""
    import ctypes

    lib = ctypes.CDLL(str(path))
    if name == "lookup_aligned":
        fn = lib.anystereo_gather_pyramid_aligned
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    else:
        fn = lib.anystereo_scatter_rows_add
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _parent_lookup(torch, vol, x, levels, out_dtype):
    out = torch.empty((vol.shape[0], levels * TAPS), dtype=out_dtype, device=DEVICE)
    err = PARENT["lookup_aligned"](vol.data_ptr(), x.data_ptr(), out.data_ptr(), vol.shape[0], vol.shape[1],
                                   TAPS, levels, int(out_dtype == torch.bfloat16),
                                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the parent's lookup kernel failed: CUDA error {err}")
    return out


def _parent_scatter(torch, idx, g, n):
    batch, q, c = g.shape
    dtbl = torch.zeros((batch, n, c), dtype=torch.float32, device=DEVICE)
    err = PARENT["gather_rows"](idx.data_ptr(), g.data_ptr(), dtbl.data_ptr(), batch, n, q, c,
                                int(g.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the parent's scatter kernel failed: CUDA error {err}")
    return dtbl


def _beside_parent(torch, res, key, fn, parent_fn):
    """Times in turns, parent, this tree, this tree, parent: `parent_<key>`
    and `<key>_beside_parent`, two each."""
    p1, n1, n2, p2 = (_time_ms(torch, f) for f in (parent_fn, fn, fn, parent_fn))
    res[f"parent_{key}"], res[f"{key}_beside_parent"] = [p1, p2], [n1, n2]


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


def _window_need(torch, starts, length, levels):
    """[R, L] mask of the volume entries inside some level's window of
    `TAPS + 1` cells, from the per-level window starts i0 ([R, levels])."""
    j = torch.arange(length, device=starts.device)
    need = torch.zeros((starts.shape[0], length), dtype=torch.bool, device=starts.device)
    for lvl in range(levels):
        width, n = 2 ** lvl, length >> lvl
        start = starts[:, lvl].clamp(0, n) * width
        end = (starts[:, lvl] + TAPS + 1).clamp(0, n) * width
        need |= (j >= start[:, None]) & (j < end[:, None])
    return need


def _lookup_flops(rows, levels):
    # 6 per tap (position, weight, two products, sum); pooling 2 per pair
    return sum(rows * (6 * TAPS + 2 * (2 ** lvl - 1) * (TAPS + 1)) for lvl in range(levels))


def _lookup_cost(torch, x, length, out_itemsize, levels):
    """Bytes and fp32 operations the aligned lookup needs for these
    positions: the volume elements inside some level's window (each read
    once), x, and the output (written once)."""
    radius = (TAPS - 1) // 2
    slack = (radius + 2) * 2 ** levels
    xc = x.clamp(-slack, length + slack)
    starts = torch.stack([torch.floor(xc / 2 ** lvl - radius).long() for lvl in range(levels)], 1)
    rows = x.shape[0]
    need = _window_need(torch, starts, length, levels)
    nbytes = 4 * int(need.sum()) + 4 * rows + out_itemsize * rows * levels * TAPS
    return nbytes, _lookup_flops(rows, levels)


def _window_cost(torch, bases, length, transposed):
    """The same for the window lookups, from the window starts `bases`
    [R, levels]: bases and the fp32 output once, and of the volume the
    entries inside some window; in the [L, R] layout whole 32-byte sectors
    (8 neighbouring rows of one entry), the least the card can fetch."""
    rows, levels = bases.shape
    starts = torch.floor(bases).clamp(-(TAPS + 1), length).long()
    need = _window_need(torch, starts, length, levels)
    if transposed:
        pad = (-rows) % 8
        need = torch.nn.functional.pad(need.to(torch.uint8), (0, 0, 0, pad))
        vol_bytes = 32 * int(need.reshape(-1, 8, length).any(dim=1).sum())
    else:
        vol_bytes = 4 * int(need.sum())
    return vol_bytes + 4 * rows * levels + 4 * rows * levels * TAPS, _lookup_flops(rows, levels)


def _bf16_ulps_ok(torch, got, want):
    """|got - want| <= one bf16 spacing at want (both are bf16 roundings of
    fp32 results that agree to FP32_ATOL)."""
    g, w = got.float(), want.float()
    _, exp = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), exp - 8)
    return bool(((g - w).abs() <= torch.maximum(ulp, torch.full_like(w, FP32_ATOL))).all())


def _lookup_shapes():
    """(call, rows, length, levels) of every lookup the main paths make: the
    IGEV pairs (GEV rows of 48, correlation rows of W/4; 2 levels) and the
    RAFT correlation alone (4 levels), at the eval (batch 1, 96x312 cells) and
    the training size (batch 2, 40x80 cells)."""
    h4, w4, groups, d = H // 4, W // 4, 8, 192 // 4
    cells, tw4 = 2 * (TRAIN_H // 4) * (TRAIN_W // 4), TRAIN_W // 4
    return (("gev", h4 * w4 * groups, d, IGEV_LEVELS), ("corr", h4 * w4, w4, IGEV_LEVELS),
            ("train_gev", cells * groups, d, IGEV_LEVELS), ("train_corr", cells, tw4, IGEV_LEVELS),
            ("raft_corr", h4 * w4, w4, RAFT_LEVELS), ("raft_train_corr", cells, tw4, RAFT_LEVELS))


def _positions(torch, gen, rows, length):
    """(x for the check, x for the timing): the check has positions over the
    row and 20 past both ends, and a few far outside [0, L) at both signs;
    the timing has positions inside the row, as disparities (GEV) and matched
    columns (corr) mostly are."""
    x_main = torch.rand(rows, device=DEVICE, generator=gen) * length
    x = torch.rand(rows, device=DEVICE, generator=gen) * (length + 40) - 20
    far = torch.tensor([*FAR, -60.0, length + 60.0], device=DEVICE)
    x[: far.numel()] = far
    return x, x_main


def _path_positions(torch, call, rows):
    """Positions shaped as the main path gives them: a smooth disparity field
    d over the cells (4 to 40 cells; eval 1x96x312, training 2x40x80); the
    GEV volume has one x = d for each run of 8 consecutive rows (a cell's
    groups), the correlation x = column - d."""
    import math

    batch, h4, w4 = (TRAIN_BATCH, TRAIN_H // 4, TRAIN_W // 4) if "train" in call else (1, H // 4, W // 4)
    hh = torch.arange(h4, device=DEVICE, dtype=torch.float32)[:, None] / h4
    ww = torch.arange(w4, device=DEVICE, dtype=torch.float32)[None, :]
    d = torch.stack([22 + 18 * torch.sin(2 * math.pi * (1.5 * ww / w4 + 0.5 * hh + 0.3 * b))
                     * torch.cos(math.pi * hh) for b in range(batch)])
    x = d.reshape(-1).repeat_interleave(8) if call.endswith("gev") else (ww - d).reshape(-1)
    assert x.numel() == rows, (call, x.numel(), rows)
    return x.contiguous()


def _check_lookup(torch, res, tag, vol, x, levels):
    """B1 against its plain version (fp32 within FP32_ATOL, bf16 within one
    ulp) and, with --parent, against the parent's kernel bit for bit."""
    from anystereo_tpu_torch.ops.kernels.lookup import (
        gather_pyramid_aligned,
        gather_pyramid_aligned_ref,
    )

    call = res["call"]
    for out_dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        got = gather_pyramid_aligned(vol, x, TAPS, levels, out_dtype)
        want = gather_pyramid_aligned_ref(vol, x, TAPS, levels, out_dtype)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if out_dtype == torch.float32 and not err <= FP32_ATOL:
            raise AssertionError(f"{call} {tag} fp32: max |kernel - plain| {err} > {FP32_ATOL}")
        if out_dtype == torch.bfloat16 and not _bf16_ulps_ok(torch, got, want):
            raise AssertionError(f"{call} {tag} bf16: kernel and plain differ by more than 1 ulp")
        res[f"max_abs_err_{tag}{name}"] = err
        res["max_abs_err"] = max(res.get("max_abs_err", 0.0), err if name == "fp32" else 0.0)
        if PARENT:
            if not torch.equal(got, _parent_lookup(torch, vol, x, levels, out_dtype)):
                raise AssertionError(f"{call} {tag} {name}: differs from the parent's kernel")
            res["equal_to_parent"] = True


def _kernels_lookup_fwd(torch):
    from anystereo_tpu_torch.ops.kernels.lookup import (
        gather_pyramid_aligned,
        gather_pyramid_aligned_ref,
    )

    g = torch.Generator(device=DEVICE).manual_seed(0)
    calls = []
    bf16 = torch.bfloat16
    for call, rows, length, levels in _lookup_shapes():
        vol = torch.randn(rows, length, device=DEVICE, generator=g)
        x, x_main = _positions(torch, g, rows, length)
        x_path = _path_positions(torch, call, rows)
        res = {"call": call, "rows": rows, "length": length, "levels": levels}
        _check_lookup(torch, res, "", vol, x, levels)
        _check_lookup(torch, res, "path_", vol, x_path, levels)
        # the main path asks for bf16 out
        res["ms"] = _time_ms(torch, lambda: gather_pyramid_aligned(vol, x_main, TAPS, levels, bf16))
        res["ms_path"] = _time_ms(torch, lambda: gather_pyramid_aligned(vol, x_path, TAPS, levels, bf16))
        res["floor_ms"] = _time_ms(torch, lambda: gather_pyramid_aligned(
            vol[:1], x_main[:1], TAPS, levels, bf16))
        res["plain_ms"] = _time_ms(torch, lambda: gather_pyramid_aligned_ref(
            vol, x_main, TAPS, levels, bf16), reps=5)
        if PARENT:
            for key, pos in (("ms", x_main), ("ms_path", x_path)):
                _beside_parent(torch, res, key, lambda: gather_pyramid_aligned(vol, pos, TAPS, levels, bf16),
                               lambda: _parent_lookup(torch, vol, pos, levels, bf16))
        nbytes, flops = _lookup_cost(torch, x_main, length, 2, levels)
        res["bytes"], res["flops"] = nbytes, flops
        res["bound_ms"], res["bound_by"] = _bound(nbytes, flops)
        res["bytes_path"] = _lookup_cost(torch, x_path, length, 2, levels)[0]
        res["bound_ms_path"] = _bound(res["bytes_path"], flops)[0]
        # a yardstick for what the bound assumes: a PyTorch copy that reads
        # and writes as many bytes in all, timed the same way (L2 left full of
        # the flush's dirty lines)
        src = torch.empty(nbytes // 8, device=DEVICE)
        dst = torch.empty_like(src)
        res["copy_ms"] = _time_ms(torch, lambda: dst.copy_(src))
        del src, dst
        parent = "" if not PARENT else (
            f"; parent {res['parent_ms']} / this tree {res['ms_beside_parent']} ms in turns, path-shaped "
            f"parent {res['parent_ms_path']} / this tree {res['ms_path_beside_parent']} ms; equal to "
            f"the parent's output bit for bit")
        _log(f"[kernels] gather_pyramid_aligned {call} R={rows} L={length} levels={levels}: "
             f"max|diff| fp32 {res['max_abs_err_fp32']:.3g} bf16 {res['max_abs_err_bf16']:.3g} (path-shaped "
             f"{res['max_abs_err_path_fp32']:.3g}, {res['max_abs_err_path_bf16']:.3g}); kernel "
             f"{res['ms']:.4f} ms, path-shaped {res['ms_path']:.4f} ms (bound "
             f"{res['bound_ms_path']:.4f}), floor {res['floor_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
             f"bound {res['bound_ms']:.4f} ms ({nbytes} B; a copy of as many bytes {res['copy_ms']:.4f} "
             f"ms){parent}")
        del vol, x, x_main, x_path
        calls.append(res)
    # the record's times are one IGEV eval GRU iteration's pair of calls (GEV
    # then corr), bf16 out; the other calls stand in `per_call`.  No single
    # PyTorch call computes this lookup
    return _record("gather_pyramid_aligned", "anystereo_tpu_torch/csrc/lookup_aligned.cu",
                   "anystereo_tpu/ops/pallas/lookup_kernel.py:1103", calls, main=(0, 1),
                   paths=("eval_igev", "train_igev", "eval_raft"))


def _bound(nbytes, flops):
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def _record(name, source, replaces, calls, main, paths, library=False):
    """One entry of the `kernels` line: the times are those of the calls the
    main path makes (`main`: indices into `calls`), summed.  `paths`: the
    system paths that launch the kernel, or ("op",) for one reached only as a
    public function (in the JAX package too)."""
    picked = [calls[i] for i in main]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "paths": list(paths),
        "ms": sum(c["ms"] for c in picked),
        "plain_ms": sum(c["plain_ms"] for c in picked),
        "bound_ms": sum(c["bound_ms"] for c in picked),
        "bound_by": "bytes" if all(c["bound_by"] == "bytes" for c in picked) else "operations",
        "max_abs_err": max(c["max_abs_err"] for c in calls),
        "library_ms": sum(c["library_ms"] for c in picked) if library else None,
        **({"floor_ms": sum(c["floor_ms"] for c in picked)} if all("floor_ms" in c for c in picked) else {}),
        "per_call": calls,
    }


def _kernels_lookup_bwd(torch):
    """The aligned lookup's backward at the training shapes (batch 2, 40x80
    cells: GEV rows of 48 and correlation rows of 80 at 2 levels, the RAFT
    correlation at 4) and at the RAFT eval shape, against its plain version.
    The kernel repeats the plain version's operations in its order, so the
    two must agree exactly, with the cotangent in fp32 and in bf16."""
    from anystereo_tpu_torch.ops.kernels.lookup import (
        gather_pyramid_aligned_bwd,
        gather_pyramid_aligned_bwd_ref,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    calls = []
    shapes = {c[0]: c for c in _lookup_shapes()}
    for call in ("train_gev", "train_corr", "raft_train_corr", "raft_corr"):
        _, rows, length, levels = shapes[call]
        x, x_main = _positions(torch, gen, rows, length)
        g32 = torch.randn(rows, levels * TAPS, device=DEVICE, generator=gen)
        res = {"call": call, "rows": rows, "length": length, "levels": levels}
        for g in (g32, g32.bfloat16()):
            got = gather_pyramid_aligned_bwd(x, g, length, TAPS, levels)
            want = gather_pyramid_aligned_bwd_ref(x, g, length, TAPS, levels)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if err != 0.0 or not bool((got[: len(FAR)] == 0).all()):
                raise AssertionError(f"lookup backward {call} {g.dtype}: max |kernel - plain| "
                                     f"{err}, want 0 (and zero rows for far positions)")
            res["max_abs_err"] = max(res.get("max_abs_err", 0.0), err)
        g = g32.bfloat16()  # the main path's cotangent is bf16
        res["ms"] = _time_ms(torch, lambda: gather_pyramid_aligned_bwd(x_main, g, length, TAPS, levels))
        res["plain_ms"] = _time_ms(torch, lambda: gather_pyramid_aligned_bwd_ref(
            x_main, g, length, TAPS, levels), reps=5)
        # g and x read once, the whole of dvol written once; per row a
        # product and a sum per tap side, a scale and a sum per entry and level
        res["bytes"] = rows * (levels * TAPS * 2 + 4 + length * 4)
        res["flops"] = rows * levels * (4 * TAPS + 2 * length)
        res["bound_ms"], res["bound_by"] = _bound(res["bytes"], res["flops"])
        _log(f"[kernels] gather_pyramid_aligned_bwd {call} R={rows} L={length} levels={levels}: "
             f"max|diff| {res['max_abs_err']:.3g}; kernel {res['ms']:.4f} ms, plain "
             f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bytes']} B)")
        calls.append(res)
    return _record("gather_pyramid_aligned_bwd", "anystereo_tpu_torch/csrc/lookup_aligned.cu",
                   "anystereo_tpu/ops/pallas/lookup_kernel.py:965", calls, main=(0, 1),
                   paths=("train_igev",))


def _kernels_window(torch):
    """The window-pyramid lookups in their three layouts, forward and
    backward, at every shape a main path gives the "classify" flavor (the
    RAFT correlation at 4 levels; the IGEV pair at 2), fp32.  Kernel and plain
    version do the same operations in the same order (explicit round-to-nearest
    intrinsics, no FMA), so they must agree exactly, not to a tolerance; the
    three layouts must give one and the same result; far positions (+-1e6,
    +-3e9 in the bases) must give zero taps and written zero gradients."""
    from anystereo_tpu_torch.ops.kernels import lookup_window as tw

    src = "anystereo_tpu_torch/csrc/lookup_window.cu"
    layouts = (  # name, forward, backward, JAX line fwd/bwd, volume transposed, output transposed
        ("gather_pyramid_window_pm", tw.gather_pyramid_window_pm, tw.gather_pyramid_window_pm_bwd,
         767, 466, True, False),
        ("gather_pyramid_window_t", tw.gather_pyramid_window_t, tw.gather_pyramid_window_t_bwd,
         798, 466, True, True),
        ("gather_pyramid_window", tw.gather_pyramid_window, tw.gather_pyramid_window_bwd,
         357, 289, False, False),
    )
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    radius = (TAPS - 1) // 2
    calls = {name + tag: [] for name, *_ in layouts for tag in ("", "_bwd")}
    for call, rows, length, levels in _lookup_shapes():
        vol = torch.randn(rows, length, device=DEVICE, generator=gen)
        x, x_main = _positions(torch, gen, rows, length)
        scales = torch.tensor([2.0 ** -lvl for lvl in range(levels)], device=DEVICE)
        bases, bases_main = x[:, None] * scales - radius, x_main[:, None] * scales - radius
        bases[0, :], bases[1, :] = -3e9, 3e9  # beyond int32: not clamped by any caller
        cot = torch.randn(rows, levels * TAPS, device=DEVICE, generator=gen)
        results = {}
        for name, fwd, bwd, _, _, vol_t, out_t in layouts:
            ref, bwd_ref = getattr(tw, name + "_ref"), getattr(tw, name + "_bwd_ref")
            tr = (lambda a: a.t().contiguous())
            v, b, bm = (tr(vol), tr(bases), tr(bases_main)) if vol_t else (vol, bases, bases_main)
            g = tr(cot) if out_t else cot
            got, want = fwd(v, b, TAPS), ref(v, b, TAPS)
            dgot, dwant = bwd(b, g, length, TAPS), bwd_ref(b, g, length, TAPS)
            torch.cuda.synchronize()
            rows_out = got.t() if out_t else got
            rows_grad = dgot.t() if vol_t else dgot
            for what, a, w, far_rows in (("forward", got, want, rows_out), ("backward", dgot, dwant, rows_grad)):
                err = float((a - w).abs().max())
                if err != 0.0 or a.shape != w.shape or bool(far_rows[: len(FAR)].any()):
                    raise AssertionError(f"{name} {what} {call}: max |kernel - plain| {err}, want 0 "
                                         f"(and zeros for far positions)")
            results[name] = (rows_out, rows_grad)
            f_bytes, f_flops = _window_cost(torch, bases_main, length, vol_t)
            # backward: bases and g read once, the whole of dvol written once;
            # per row the slot coefficients, per entry and level a sum
            b_bytes = 4 * rows * (levels + levels * TAPS + length)
            b_flops = rows * levels * (4 * (TAPS + 1) + length)
            for tag, fn, plain, nbytes, flops in (
                    ("", lambda: fwd(v, bm, TAPS), lambda: ref(v, bm, TAPS), f_bytes, f_flops),
                    ("_bwd", lambda: bwd(bm, g, length, TAPS), lambda: bwd_ref(bm, g, length, TAPS),
                     b_bytes, b_flops)):
                res = {"call": call, "rows": rows, "length": length, "levels": levels,
                       "max_abs_err": 0.0, "bytes": nbytes, "flops": flops}
                res["ms"] = _time_ms(torch, fn)
                res["plain_ms"] = _time_ms(torch, plain, reps=5)
                res["bound_ms"], res["bound_by"] = _bound(nbytes, flops)
                _log(f"[kernels] {name}{tag} {call} R={rows} L={length} levels={levels}: exact; "
                     f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, bound "
                     f"{res['bound_ms']:.4f} ms ({nbytes} B)")
                calls[name + tag].append(res)
        base_out, base_grad = results["gather_pyramid_window_pm"]
        for name, (o, d) in results.items():
            if not (torch.equal(o, base_out) and torch.equal(d, base_grad)):
                raise AssertionError(f"{name} {call}: differs from gather_pyramid_window_pm on the "
                                     "same operands in its layout")
        del vol, cot, results
    order = [c[0] for c in _lookup_shapes()]
    records = []
    for name, _, _, line_fwd, line_bwd, vol_t, out_t in layouts:
        system = name == "gather_pyramid_window_pm"
        for tag, line, main_call, paths in (
                ("", line_fwd, "raft_corr", ("eval_raft", "train_raft")),
                ("_bwd", line_bwd, "raft_train_corr", ("train_raft",))):
            records.append(_record(
                name + tag, src, f"anystereo_tpu/ops/pallas/lookup_kernel.py:{line}", calls[name + tag],
                main=(order.index(main_call),), paths=paths if system else ("op",)))
    return records


def _kernels_hybrid(torch):
    """`gather_rows_hybrid` (plain indexing forward, scatter-add kernel
    backward): nothing dispatches to it; it stays a public function, as in
    the JAX package, and is held here on the 9-tap table."""
    from anystereo_tpu_torch.ops.kernels.gather import (
        gather_rows_hybrid,
        gather_rows_ref,
        scatter_rows_add,
        scatter_rows_add_ref,
    )

    batch, n, c, q = 2, 3200, 9, TRAIN_H * TRAIN_W
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    table = torch.randn(batch, n, c, device=DEVICE, generator=gen, requires_grad=True)
    idx = torch.randint(0, n, (batch, q), device=DEVICE, generator=gen, dtype=torch.int32)
    g = torch.randn(batch, q, c, device=DEVICE, generator=gen)
    before = scatter_rows_add.launches
    out = gather_rows_hybrid(table, idx)
    out.backward(g)
    torch.cuda.synchronize()
    launched = scatter_rows_add.launches - before
    plain = table.detach().clone().requires_grad_(True)
    gather_rows_ref(plain, idx).backward(g)  # PyTorch's own autograd
    bound = SCATTER_RTOL * (1.0 + scatter_rows_add_ref(idx, g.abs(), n))
    diff = (table.grad - plain.grad).abs()
    if launched != 1 or not torch.equal(out.detach(), gather_rows_ref(plain.detach(), idx)) \
            or not bool((diff <= bound).all()):
        raise AssertionError(f"gather_rows_hybrid: {launched} scatter launches, max |diff| "
                             f"{float(diff.max())}")
    det = table.detach()
    res = {"table": [batch, n, c], "dtype": "float32", "queries": q, "max_abs_err": float(diff.max())}

    def fwd_bwd(fn):
        t = det.clone().requires_grad_(True)
        fn(t, idx).backward(g)

    res["ms"] = _time_ms(torch, lambda: fwd_bwd(gather_rows_hybrid))
    res["plain_ms"] = _time_ms(torch, lambda: fwd_bwd(gather_rows_ref))
    res["bytes"] = 2 * (idx.numel() * 4 + det.numel() * 4 + g.numel() * 4)
    res["flops"] = g.numel()
    res["bound_ms"], res["bound_by"] = _bound(res["bytes"], res["flops"])
    _log(f"[kernels] gather_rows_hybrid {res['table']} forward+backward: max|diff| "
         f"{res['max_abs_err']:.3g}; {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, bound "
         f"{res['bound_ms']:.4f} ms")
    rec = _record("gather_rows_hybrid", "anystereo_tpu_torch/csrc/gather_rows.cu",
                  "anystereo_tpu/ops/pallas/gather_kernel.py:355", [res], main=(0,), paths=("op",))
    rec["op_launches"] = launched
    return rec


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
        scatter_vec,
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
        res = dict(shape, max_abs_err=float(diff.max()), vec=scatter_vec(c, dtype, g.data_ptr()))
        if PARENT:
            pdiff = (_parent_scatter(torch, idx, g, n) - want).abs()
            if not bool((pdiff <= SCATTER_RTOL * (1.0 + row_abs)).all()):
                raise AssertionError(f"the parent's scatter_rows_add {shape}: max |diff| {float(pdiff.max())}")
            _beside_parent(torch, res, "ms", lambda: scatter_rows_add(idx, g, n),
                           lambda: _parent_scatter(torch, idx, g, n))
        res["ms"] = _time_ms(torch, lambda: scatter_rows_add(idx, g, n))
        # one query a sample, the same table: the launch and the zero-fill
        idx1, g1 = idx[:, :1].contiguous(), g[:, :1].contiguous()
        res["floor_ms"] = _time_ms(torch, lambda: scatter_rows_add(idx1, g1, n))
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
        parent = "" if not PARENT else (
            f"; parent {res['parent_ms']} / this tree {res['ms_beside_parent']} ms in turns")
        _log(f"[kernels] scatter_rows_add {shape}: max|diff| {res['max_abs_err']:.3g}; kernel "
             f"{res['ms']:.4f} ms ({res['vec']} channels a lane), floor "
             f"{res['floor_ms']:.4f} ms, plain "
             f"{res['plain_ms']:.4f} ms, index_add_ {res['library_ms']:.4f} ms, bound "
             f"{res['bound_ms']:.4f} ms ({res['bytes']} B){parent}")
        bwd.append(res)
        del table, idx, g, got, want, out, g32, idx1, g1
    src = "anystereo_tpu_torch/csrc/gather_rows.cu"
    # per decode all three tables go through the gather forward and the
    # scatter backward
    paths = ("train_igev", "train_raft")
    return [
        _record("gather_rows", src, "anystereo_tpu/ops/pallas/gather_kernel.py:319", fwd,
                main=(0, 1, 2), paths=paths, library=True),
        _record("scatter_rows_add", src, "anystereo_tpu/ops/pallas/gather_kernel.py:355", bwd,
                main=(0, 1, 2), paths=paths, library=True),
    ]


def _level_shapes():
    """(call, rows, length) of every `gather_window_linear` launch of one GRU
    iteration under the "levels" flavor: at 1x384x1248 the IGEV pair (GEV
    rows of 48 and 24, correlation rows of 312 and 156) and the four RAFT
    correlation levels, then the IGEV pair of the training step (batch 2,
    40x80 cells: GEV rows of 48 and 24, correlation rows of 80 and 40)."""
    def igev(prefix, cells, w4, groups=8, d=192 // 4):
        return [(f"{prefix}gev_l{i}", cells * groups, d >> i) for i in range(IGEV_LEVELS)] + \
            [(f"{prefix}corr_l{i}", cells, w4 >> i) for i in range(IGEV_LEVELS)]

    h4, w4, th4, tw4 = H // 4, W // 4, TRAIN_H // 4, TRAIN_W // 4
    return igev("", h4 * w4, w4) + \
        [(f"raft_corr_l{i}", h4 * w4, w4 >> i) for i in range(RAFT_LEVELS)] + \
        igev("train_", TRAIN_BATCH * th4 * tw4, tw4)


def _old_gather_1d_linear(torch, vol, pos):
    """The body `ops/sampling.gather_1d_linear` had before it went through
    the kernel (two `torch.gather`s and their masks): the library column."""
    length = vol.shape[-1]
    x0f = torch.floor(pos)
    w1 = pos - x0f
    i0 = x0f.long()
    i1 = i0 + 1
    valid0 = ((i0 >= 0) & (i0 <= length - 1)).to(vol.dtype)
    valid1 = ((i1 >= 0) & (i1 <= length - 1)).to(vol.dtype)
    v0 = torch.gather(vol, -1, i0.clamp(0, length - 1))
    v1 = torch.gather(vol, -1, i1.clamp(0, length - 1))
    return v0 * valid0 * (1.0 - w1) + v1 * valid1 * w1


def _kernels_linear(torch):
    """The single-level linear lookups, forward and backward, fp32.  Kernel
    and plain version do the same operations in the same order (explicit
    round-to-nearest intrinsics, no FMA; the rows backward adds a row's taps
    in ascending k, no atomics), so they must agree exactly; far positions
    (+-1e6, +-3e9) must give zero taps and written zero gradients."""
    from anystereo_tpu_torch.ops.kernels import lookup_linear as tl

    src, jax_file = "anystereo_tpu_torch/csrc/lookup_linear.cu", "anystereo_tpu/ops/pallas/lookup_kernel.py"
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    far = torch.tensor([-3e9, 3e9, -1e6, 1e6], device=DEVICE)

    def timed(res, what, fn, plain, nbytes, flops, library=None):
        res.update(max_abs_err=0.0, bytes=nbytes, flops=flops)
        res["ms"] = _time_ms(torch, fn)
        res["plain_ms"] = _time_ms(torch, plain, reps=5)
        res["library_ms"] = None if library is None else _time_ms(torch, library)
        res["bound_ms"], res["bound_by"] = _bound(nbytes, flops)
        lib = "" if library is None else f", torch.gather body {res['library_ms']:.4f} ms"
        _log(f"[kernels] {what} {res['call']} R={res['rows']} L={res['length']} K={res['taps']}: "
             f"exact; kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms{lib}, bound "
             f"{res['bound_ms']:.4f} ms ({nbytes} B)")
        return res

    # the window form at the eight eval level shapes and the four training ones
    win_fwd, win_bwd = [], []
    for call, rows, length in _level_shapes():
        vol = torch.randn(rows, length, device=DEVICE, generator=gen)
        base_main = torch.rand(rows, device=DEVICE, generator=gen) * length - (TAPS - 1) // 2
        base = torch.rand(rows, device=DEVICE, generator=gen) * (length + 40) - 20 - (TAPS - 1) // 2
        base[:4] = far
        cot = torch.randn(rows, TAPS, device=DEVICE, generator=gen)
        got, want = tl.gather_window_linear(vol, base, TAPS), tl.gather_window_linear_ref(vol, base, TAPS)
        dgot = tl.gather_window_linear_bwd(base, cot, length, TAPS)
        dwant = tl.gather_window_linear_bwd_ref(base, cot, length, TAPS)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(dgot, dwant)) or bool(got[:4].any()) \
                or bool(dgot[:4].any()):
            raise AssertionError(f"gather_window_linear {call}: max |kernel - plain| forward "
                                 f"{float((got - want).abs().max())}, backward "
                                 f"{float((dgot - dwant).abs().max())}, want 0 (and zeros for far starts)")
        shape = {"call": call, "rows": rows, "length": length, "taps": TAPS}
        i0 = torch.floor(base_main).long()
        live = (i0 + TAPS + 1).clamp(0, length) - i0.clamp(0, length)  # entries inside the window
        win_fwd.append(timed(
            dict(shape), "gather_window_linear", lambda: tl.gather_window_linear(vol, base_main, TAPS),
            lambda: tl.gather_window_linear_ref(vol, base_main, TAPS),
            4 * int(live.sum()) + 4 * rows + 4 * rows * TAPS, 4 * rows * TAPS))
        win_bwd.append(timed(
            dict(shape), "gather_window_linear_bwd",
            lambda: tl.gather_window_linear_bwd(base_main, cot, length, TAPS),
            lambda: tl.gather_window_linear_bwd_ref(base_main, cot, length, TAPS),
            4 * rows * (1 + TAPS + length), 4 * rows * (TAPS + 1)))
        del vol, cot

    # arbitrary positions: the evaluator's occlusion warp, and the small op shape
    rows_fwd, rows_bwd = [], []
    for call, rows, length, taps in (("occ_mask", EVAL_H, EVAL_W, EVAL_W), ("op_300x312x9", 300, 312, 9)):
        vol = torch.rand(rows, length, device=DEVICE, generator=gen) * 60
        if call == "occ_mask":  # x - disparity, as `warp_disparity` forms it
            pos_main = torch.arange(length, device=DEVICE, dtype=torch.float32) - vol
        else:
            pos_main = torch.rand(rows, taps, device=DEVICE, generator=gen) * length
        pos = pos_main + torch.randn(rows, taps, device=DEVICE, generator=gen) * 8
        pos[0, :4] = far
        pos[1] = 2.25  # every tap of a row on one entry
        cot = torch.randn(rows, taps, device=DEVICE, generator=gen)
        got, want = tl.gather_rows_linear(vol, pos), tl.gather_rows_linear_ref(vol, pos)
        dgot = tl.gather_rows_linear_bwd(pos, cot, length)
        dwant = tl.gather_rows_linear_bwd_ref(pos, cot, length)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(dgot, dwant)) or bool(got[0, :4].any()):
            raise AssertionError(f"gather_rows_linear {call}: max |kernel - plain| forward "
                                 f"{float((got - want).abs().max())}, backward "
                                 f"{float((dgot - dwant).abs().max())}, want 0 (and zeros for far taps)")
        if not torch.allclose(_old_gather_1d_linear(torch, vol, pos_main),
                              tl.gather_rows_linear(vol, pos_main), rtol=0, atol=FP32_ATOL):
            raise AssertionError(f"gather_rows_linear {call} disagrees with the torch.gather body")
        shape = {"call": call, "rows": rows, "length": length, "taps": taps}
        i0 = torch.floor(pos_main).clamp(-2, length).long()
        touched = torch.zeros(rows, length + 4, dtype=torch.bool, device=DEVICE)
        touched.scatter_(1, i0 + 2, True)
        touched.scatter_(1, i0 + 3, True)
        vol_bytes = 4 * int(touched[:, 2:length + 2].sum())  # each entry some tap reads, once
        rows_fwd.append(timed(
            dict(shape), "gather_rows_linear", lambda: tl.gather_rows_linear(vol, pos_main),
            lambda: tl.gather_rows_linear_ref(vol, pos_main), vol_bytes + 8 * rows * taps,
            4 * rows * taps, library=lambda: _old_gather_1d_linear(torch, vol, pos_main)))
        rows_bwd.append(timed(
            dict(shape), "gather_rows_linear_bwd", lambda: tl.gather_rows_linear_bwd(pos_main, cot, length),
            lambda: tl.gather_rows_linear_bwd_ref(pos_main, cot, length),
            4 * rows * (2 * taps + length), 5 * rows * taps))
        del vol, cot
    # one IGEV iteration's four launches: the forward's at the eval shapes, the
    # backward's at the training shapes (the one path that runs it)
    calls = [c["call"] for c in win_fwd]
    eval_iteration = tuple(calls.index(f"{v}_l{i}") for v in ("gev", "corr") for i in range(IGEV_LEVELS))
    train_iteration = tuple(calls.index(f"train_{v}_l{i}") for v in ("gev", "corr")
                            for i in range(IGEV_LEVELS))
    return [
        _record("gather_window_linear", src, f"{jax_file}:215", win_fwd, main=eval_iteration,
                paths=("eval_levels", "train_levels")),
        _record("gather_window_linear_bwd", src, f"{jax_file}:155", win_bwd, main=train_iteration,
                paths=("train_levels",)),
        _record("gather_rows_linear", src, f"{jax_file}:1137", rows_fwd, main=(0,),
                paths=("validate",), library=True),
        _record("gather_rows_linear_bwd", src, f"{jax_file}:63", rows_bwd, main=(0,), paths=("op",)),
    ]


def phase_kernels(torch):
    """The records of the `kernels` line; an "op" record carries the launches
    this phase counted for it (`op_launches`)."""
    from anystereo_tpu_torch.ops.kernels import lookup_linear as tl
    from anystereo_tpu_torch.ops.kernels import lookup_window as tw

    op_fns = {f.__name__: f for f in (tw.gather_pyramid_window_t, tw.gather_pyramid_window_t_bwd,
                                      tw.gather_pyramid_window, tw.gather_pyramid_window_bwd,
                                      tl.gather_rows_linear_bwd)}
    for f in op_fns.values():
        f.launches = 0
    records = [_kernels_lookup_fwd(torch), _kernels_lookup_bwd(torch), *_kernels_window(torch),
               *_kernels_gather(torch), _kernels_hybrid(torch), *_kernels_linear(torch)]
    for record in records:
        if record["name"] in op_fns:
            record["op_launches"] = op_fns[record["name"]].launches
    return records


# ----------------------------------------------------------------- phase 3


def _images(torch, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    left = torch.rand(1, H, W, 3, device=DEVICE, generator=g) * 255
    # the right view is the left one shifted by 24 px, so the pair has a
    # consistent disparity for the volume to find
    right = torch.roll(left, shifts=-24, dims=2)
    return left, right


@contextlib.contextmanager
def _flavor(name):
    """The process-level lookup flavor, as a user sets it."""
    old = os.environ.get("ANYSTEREO_LOOKUP_KERNEL")
    os.environ["ANYSTEREO_LOOKUP_KERNEL"] = name
    try:
        yield
    finally:
        if old is None:
            del os.environ["ANYSTEREO_LOOKUP_KERNEL"]
        else:
            os.environ["ANYSTEREO_LOOKUP_KERNEL"] = old


def _config(core, **kw):
    from anystereo_tpu_torch.config import ModelConfig, raft_config

    return ModelConfig(**kw) if core == "igev" else raft_config(**kw)


def _lookup_counts(core, flavor, per_volume):
    """Expected launches of the three lookup forwards for `per_volume` lookups
    of each volume: the IGEV core has two volumes, RAFT one; the "levels"
    flavor launches once a level of each (IGEV 2 levels, RAFT 4)."""
    n = per_volume * (2 if core == "igev" else 1)
    levels = IGEV_LEVELS if core == "igev" else RAFT_LEVELS
    return {"gather_pyramid_aligned": n if flavor == "aligned" else 0,
            "gather_pyramid_window_pm": n if flavor == "classify" else 0,
            "gather_window_linear": n * levels if flavor == "levels" else 0}


def phase_model(torch, kernels, core, flavor, keep=False):
    """One warm-up and REQUESTS timed eval forwards of one model under one
    lookup flavor at full width; the counts are set to 0 just before and read
    just after.  Returns (launches, model or None)."""
    from anystereo_tpu_torch.nn.model import build_model

    model = build_model(_config(core), device=DEVICE, seed=0)
    left, right = _images(torch, 1)
    want = dict.fromkeys((k.__name__ for k in kernels), 0)
    want.update(_lookup_counts(core, flavor, ITERS))
    for k in kernels:
        k.launches = 0
    times = []
    torch.cuda.reset_peak_memory_stats()
    with _flavor(flavor):
        for i in range(1 + REQUESTS):
            before = _counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(left, right, iters=ITERS)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            if i:
                times.append(dt)
            _expect_launches(kernels, before, want, f"{core} eval forward {i} ({flavor})")
            disp = out.disp_final
            if tuple(disp.shape) != (1, H, W) or not bool(torch.isfinite(disp).all()):
                raise AssertionError(f"disp_final {tuple(disp.shape)} not finite [1, {H}, {W}]")
    launches = {k.__name__: k.launches for k in kernels}
    PAIR_MS[(core, flavor)] = sum(times) / len(times)
    _log(f"[model] {core.upper()} eval 1x{H}x{W}, {ITERS} iters, bf16, lookup {flavor}: "
         f"{sum(times) / len(times):.2f} ms/pair over {REQUESTS} requests "
         f"({', '.join(f'{t:.2f}' for t in times)} ms; warm-up excluded), "
         f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
         f"disp_final range [{float(disp.min()):.3f}, {float(disp.max()):.3f}] px; "
         f"launches {({k: v for k, v in launches.items() if v})}")
    return launches, (model if keep else None)


# ----------------------------------------------------------------- phase 4


class _MemoryDataset:
    """Seeded frames held in memory, as `validate_dataset` reads a dataset:
    the right view is the left one shifted by 24 px; the left ground truth is
    24 px with a step to 48 px at mid-width (an occluding edge) and the right
    view's ground truth agrees with it away from that edge, so the
    left-right check finds a band of occluded pixels."""

    def __init__(self, torch, n, h, w, seed):
        gen = torch.Generator().manual_seed(seed)
        self.frames = []
        for _ in range(n):
            left = (torch.rand(h, w, 3, generator=gen) * 255).numpy()
            dl = torch.full((h, w), 24.0)
            dl[:, w // 2:] = 48.0
            dr = torch.full((h, w), 24.0)
            dr[:, w // 2 - 48:] = 48.0
            self.frames.append((left, torch.roll(torch.from_numpy(left), -24, 1).numpy(),
                                dl.numpy(), dr.numpy()))
        self.image_list = [[f"memory/{i}/left", f"memory/{i}/right"] for i in range(n)]
        self.disparity_list = [f"memory/{i}/disparity" for i in range(n)]

    def __len__(self):
        return len(self.frames)

    def _load_raw(self, i):
        import numpy as np

        left, right, dl, _ = self.frames[i]
        return left, right, np.stack([dl, np.zeros_like(dl)], axis=-1), np.ones_like(dl)

    def disparity_pair(self, i):
        return self.frames[i][2], self.frames[i][3]


def phase_validate(torch, kernels):
    """The evaluation entry point at KITTI size.  One warm-up frame, then,
    with the counts at 0: `validate_dataset` over EVAL_FRAMES frames with the
    left-right occlusion provider, one `infer(fixed_upscale=2)` on a
    half-size pair and one `infer(scale_test=2.0)` through `utils/resize`.
    The model's own time is read by hooks around its forward (synchronised);
    the rest of a frame is the host's: pad, transfers, the occlusion mask,
    the metrics."""
    from anystereo_tpu_torch.eval.validate import (
        Validator,
        lr_consistency_occ_provider,
        validate_dataset,
    )
    from anystereo_tpu_torch.nn.model import build_model

    model = build_model(_config("igev"), device=DEVICE, seed=0)
    ds = _MemoryDataset(torch, EVAL_FRAMES, EVAL_H, EVAL_W, seed=9)
    provider = lr_consistency_occ_provider()
    in_model, preds = [], []

    def before_forward(*_):
        torch.cuda.synchronize()
        in_model.append(-time.perf_counter())

    def after_forward(_module, _args, out):
        torch.cuda.synchronize()
        in_model[-1] += time.perf_counter()
        preds.append(out.disp_final)

    hooks = (model.register_forward_pre_hook(before_forward), model.register_forward_hook(after_forward))
    validate_dataset(model, ds, valid_iters=ITERS, occ_provider=provider, max_images=1)  # warm-up
    in_model.clear()
    preds.clear()
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = validate_dataset(model, ds, valid_iters=ITERS, occ_provider=provider)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3 / EVAL_FRAMES
    model_ms = sum(in_model) * 1e3 / EVAL_FRAMES
    keys = {f"{m}{sfx}" for m in ("epe", "d1", "thres1", "thres2", "thres3") for sfx in ("", "_occ", "_noc")}
    bad = [k for k in keys if k not in metrics or metrics[k] != metrics[k] or abs(metrics[k]) == float("inf")]
    if bad or set(metrics) != keys:
        raise AssertionError(f"validate_dataset: metrics {metrics}; missing or not finite: {bad}")
    for disp in preds:
        if tuple(disp.shape) != (1, EVAL_H, EVAL_W) or not bool(torch.isfinite(disp).all()):
            raise AssertionError(f"validate_dataset: prediction {tuple(disp.shape)} not finite "
                                 f"[1, {EVAL_H}, {EVAL_W}]")
    want = dict.fromkeys((k.__name__ for k in kernels), 0)
    want.update(gather_pyramid_aligned=2 * ITERS * EVAL_FRAMES, gather_rows_linear=EVAL_FRAMES)
    _expect_launches(kernels, [0] * len(kernels), want, f"validate_dataset over {EVAL_FRAMES} frames")
    _log(f"[validate] host share: model {model_ms:.2f} ms of {frame_ms:.2f} ms a frame; the host's "
         f"pad, transfers, occlusion mask and metrics {frame_ms - model_ms:.2f} ms "
         f"({(frame_ms - model_ms) / frame_ms:.1%})")
    vd = Validator(model, ITERS)
    half = _MemoryDataset(torch, 1, EVAL_H // 2 + 1, EVAL_W // 2 + 3, seed=10).frames[0]
    extra = {}
    for name, (left, right), kw, shape in (
            ("fixed_upscale=2", half[:2], dict(fixed_upscale=2), (2 * half[0].shape[0], 2 * half[0].shape[1])),
            ("scale_test=2.0", ds.frames[0][:2], dict(scale_test=2.0), (EVAL_H, EVAL_W))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        disp = vd.infer(left, right, **kw)
        extra[name] = (time.perf_counter() - t0) * 1e3
        if disp.shape != shape or not bool(torch.isfinite(torch.from_numpy(disp)).all()):
            raise AssertionError(f"infer({name}): {disp.shape} not finite {shape}")
    want["gather_pyramid_aligned"] += 2 * 2 * ITERS
    _expect_launches(kernels, [0] * len(kernels), want, "the validate path")
    for h in hooks:
        h.remove()
    launches = {k.__name__: k.launches for k in kernels}
    _log(f"[validate] validate_dataset, IGEV, {EVAL_FRAMES} frames of {EVAL_H}x{EVAL_W} (padded to "
         f"{H}x{W}), {ITERS} iters, bf16, occlusion split: {frame_ms:.2f} ms/frame; epe "
         f"{metrics['epe']:.3f}, d1 {metrics['d1']:.4f}, epe_occ {metrics['epe_occ']:.3f}, epe_noc "
         f"{metrics['epe_noc']:.3f} (random weights); infer(fixed_upscale=2) on "
         f"{half[0].shape[0]}x{half[0].shape[1]} {extra['fixed_upscale=2']:.2f} ms, "
         f"infer(scale_test=2.0) {extra['scale_test=2.0']:.2f} ms; launches "
         f"{({k: v for k, v in launches.items() if v})}")
    return launches


# ----------------------------------------------------------------- phase 5


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


def phase_train(torch, kernels, core, flavor, steps=TRAIN_STEPS):
    """One warm-up and `steps` timed training steps of one model under
    one lookup flavor at full width, with the exact launch counts of each:
    per iteration one lookup forward and one backward a volume, and per
    decode the three query tables through the gather kernel forward and the
    scatter-add kernel backward."""
    from anystereo_tpu_torch.config import TrainConfig
    from anystereo_tpu_torch.nn.model import build_model
    from anystereo_tpu_torch.train.state import create_train_state
    from anystereo_tpu_torch.train.step import make_train_step

    tcfg = TrainConfig()
    model = build_model(_config(core), device=DEVICE, seed=0)
    state = create_train_state(model, tcfg)
    step = make_train_step(model, tcfg)
    batch = _train_batch(torch, tcfg.batch_size, TRAIN_H, TRAIN_W, tcfg.sample_q, seed=4)
    it = tcfg.train_iters
    per_step = dict.fromkeys((k.__name__ for k in kernels), 0)
    per_step.update(_lookup_counts(core, flavor, it))
    per_step.update({name + "_bwd": n for name, n in _lookup_counts(core, flavor, it).items()})
    per_step.update(gather_rows=3 * it, scatter_rows_add=3 * it)
    for k in kernels:
        k.launches = 0
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    times, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    with _flavor(flavor):
        for i in range(1 + steps):
            before = _counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            if i:
                times.append(dt)
            _expect_launches(kernels, before, per_step, f"{core} training step {i} ({flavor})")
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
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**30
    zero = [n for n, g in grads.items() if not bool(g.any())]
    still = [n for n, p in model.named_parameters()
             if n not in zero and torch.equal(p.detach(), start[n])]
    if still:
        raise AssertionError(f"parameters with a gradient that did not change: {still}")
    _log(f"[train] {core.upper()} training step {tcfg.batch_size}x{TRAIN_H}x{TRAIN_W}, Q "
         f"{tcfg.sample_q}, {it} iters, bf16, lookup {flavor}: {sum(times) / len(times):.2f} "
         f"ms/step over {steps} steps ({', '.join(f'{t:.2f}' for t in times)} ms; warm-up "
         f"excluded), peak {peak:.2f} GiB; losses {[round(v, 4) for v in losses]}; last grad_norm "
         f"{gnorm:.3f}, lr {metrics['lr']:.3e}, epe {float(metrics['epe']):.3f} px; launches per "
         f"step {({k: v for k, v in per_step.items() if v})}; parameters with an exactly zero "
         f"gradient: {zero}")
    return launches, (model, tcfg, state, step, batch)


# ----------------------------------------------------------------- phase 6


@contextlib.contextmanager
def _all_plain(lookups_only=False):
    """Every lookup (and, unless `lookups_only`, every query gather) through
    its plain version, under PyTorch's own autograd."""
    from anystereo_tpu_torch.ops import lookup
    from anystereo_tpu_torch.ops.kernels.lookup import gather_pyramid_aligned_ref
    from anystereo_tpu_torch.ops.kernels.lookup_linear import gather_window_linear_ref
    from anystereo_tpu_torch.ops.kernels.lookup_window import gather_pyramid_window_pm_ref
    from anystereo_tpu_torch.ops.sampling import set_gather_plain

    kernel_fns = (lookup.gather_pyramid_aligned, lookup.gather_pyramid_window_pm,
                  lookup.gather_window_linear)
    lookup.gather_pyramid_aligned = gather_pyramid_aligned_ref
    lookup.gather_pyramid_window_pm = gather_pyramid_window_pm_ref
    lookup.gather_window_linear = gather_window_linear_ref
    set_gather_plain(not lookups_only)
    try:
        yield
    finally:
        (lookup.gather_pyramid_aligned, lookup.gather_pyramid_window_pm,
         lookup.gather_window_linear) = kernel_fns
        set_gather_plain(False)


def _check_eval(torch, kernels, core):
    """fp32 eval forward, CHECK_ITERS iterations: under each flavor through
    the kernels (with that flavor's launches counted: one a volume and
    iteration, none of the other's) against the same with every lookup forced
    to its plain version, and "classify" and "levels" against "aligned"."""
    from anystereo_tpu_torch.nn.model import build_model

    model = build_model(_config(core, compute_dtype="float32"), device=DEVICE, seed=0)
    left, right = _images(torch, 1)
    fields = ("disp_lowres", "disp_final") if core == "raft" else \
        ("init_disp", "disp_lowres", "disp_final")
    outs = {}
    for flavor in ("aligned", "classify", "levels"):
        want = dict.fromkeys((k.__name__ for k in kernels), 0)
        want.update(_lookup_counts(core, flavor, CHECK_ITERS))
        with _flavor(flavor):
            before = _counts(kernels)
            kernel_out = model(left, right, iters=CHECK_ITERS)
            _expect_launches(kernels, before, want, f"{core} fp32 eval forward ({flavor})")
            with _all_plain(lookups_only=True):
                plain_out = model(left, right, iters=CHECK_ITERS)
            _expect_launches(kernels, before, want, f"{core} fp32 eval forward, all plain")
        torch.cuda.synchronize()
        diffs = {f: float((getattr(kernel_out, f) - getattr(plain_out, f)).abs().max())
                 for f in fields}
        _log(f"[check] {core.upper()} fp32 forward, {CHECK_ITERS} iters, lookup {flavor}, kernel vs "
             f"plain: max |diff| {json.dumps(diffs)} (bound {MODEL_CHECK_ATOL} px)")
        if not all(d <= MODEL_CHECK_ATOL for d in diffs.values()):
            raise AssertionError(f"kernel and plain forwards disagree ({core}, {flavor}): {diffs}")
        outs[flavor] = kernel_out
    for flavor in ("classify", "levels"):
        diffs = {f: float((getattr(outs[flavor], f) - getattr(outs["aligned"], f)).abs().max())
                 for f in fields}
        _log(f"[check] {core.upper()} fp32 forward, {flavor} vs aligned: max |diff| "
             f"{json.dumps(diffs)} (bound {MODEL_CHECK_ATOL} px)")
        if not all(d <= MODEL_CHECK_ATOL for d in diffs.values()):
            raise AssertionError(f"the lookup flavors disagree ({core}, {flavor}): {diffs}")


def _fp32_train_runs(torch, core="igev", flavor="aligned"):
    """Two closures over one fp32 model and batch (batch 1, 4 iterations,
    4,096 queries): the training loss and every parameter's gradient through
    the kernels, and the same with every kernel forced to its plain version
    (the lookups to their `*_ref` under PyTorch's own autograd, the query
    gathers to plain indexing)."""
    from anystereo_tpu_torch.config import TrainConfig
    from anystereo_tpu_torch.nn.model import build_model
    from anystereo_tpu_torch.train.step import loss_and_metrics

    tcfg = TrainConfig(train_iters=CHECK_ITERS)
    model = build_model(_config(core, compute_dtype="float32"), device=DEVICE, seed=0)
    batch = _train_batch(torch, 1, TRAIN_H, TRAIN_W, 4096, seed=5)

    def through_kernels():
        for p in model.parameters():
            p.grad = None
        with _flavor(flavor):
            loss, _ = loss_and_metrics(model, tcfg, batch)
            loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}

    def plain():
        with _all_plain():
            return through_kernels()

    return through_kernels, plain


def _grad_diff(got, want):
    """(worst ||dg|| / ||g||, its parameter, the parameters past the bound).
    The bound's absolute part is GRAD_CHECK_ATOL or, if larger, 1e-8 of the
    largest gradient norm: a conv bias in front of an instance norm (the RAFT
    matching encoder's) has a true gradient of zero, and what both runs hold
    there is the rounding noise of sums of that size."""
    worst, worst_name, bad = 0.0, None, []
    floor = max([GRAD_CHECK_ATOL] + [1e-8 * float(g.norm()) for g in want.values() if g is not None])
    for name, g in want.items():
        if g is None or got[name] is None:  # not reached by the loss: on both sides
            if g is not got[name]:
                bad.append((name, "reached on one side only"))
            continue
        delta, norm = float((got[name] - g).norm()), float(g.norm())
        if norm > floor and delta / norm > worst:
            worst, worst_name = delta / norm, name
        if not delta <= GRAD_CHECK_RTOL * norm + floor:
            bad.append((name, delta, norm))
    return worst, worst_name, bad


def _check_train(torch, kernels, core, flavor):
    """fp32 training loss and gradients through the kernels against the same
    with every kernel forced to its plain version (which launches nothing)."""
    through_kernels, plain = _fp32_train_runs(torch, core, flavor)
    want = dict.fromkeys((k.__name__ for k in kernels), 0)
    want.update(_lookup_counts(core, flavor, CHECK_ITERS))
    want.update({name + "_bwd": n for name, n in _lookup_counts(core, flavor, CHECK_ITERS).items()})
    want.update(gather_rows=3 * CHECK_ITERS, scatter_rows_add=3 * CHECK_ITERS)
    before = _counts(kernels)
    k_loss, k_grads = through_kernels()
    _expect_launches(kernels, before, want, f"{core} fp32 forward and backward ({flavor})")
    p_loss, p_grads = plain()
    _expect_launches(kernels, before, want, f"{core} fp32 forward and backward, all plain")
    worst, worst_name, bad = _grad_diff(k_grads, p_grads)
    rel = abs(k_loss - p_loss) / abs(p_loss)
    _log(f"[check] {core.upper()} fp32 training loss and gradients, {CHECK_ITERS} iters, lookup "
         f"{flavor}, kernels vs plain: loss "
         f"{k_loss:.6f} vs {p_loss:.6f} (relative {rel:.2e}, bound {LOSS_CHECK_RTOL}); worst "
         f"||dg||/||g|| {worst:.2e} ({worst_name}) over {len(p_grads)} parameters "
         f"(bound {GRAD_CHECK_RTOL})")
    if not rel <= LOSS_CHECK_RTOL or bad:
        raise AssertionError(f"kernel and plain training disagree: loss {k_loss} vs {p_loss}; {bad}")


def _check_occlusion(torch):
    """The left-right occlusion mask through the kernel against the same
    arithmetic on the plain version: identical masks."""
    from anystereo_tpu_torch.eval.occlusion import occ_mask
    from anystereo_tpu_torch.ops.kernels import lookup_linear as tl

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    dl = torch.rand(1, EVAL_H, EVAL_W, device=DEVICE, generator=gen) * 60
    dr = torch.rand(1, EVAL_H, EVAL_W, device=DEVICE, generator=gen) * 60
    before = tl.gather_rows_linear.launches
    mask = occ_mask(dl, dr)
    xs = torch.arange(EVAL_W, device=DEVICE, dtype=torch.float32)
    plain = (dl - tl.gather_rows_linear_ref(dr, xs - dl)).abs() > 3.0
    torch.cuda.synchronize()
    share = float(mask.float().mean())
    _log(f"[check] occ_mask {EVAL_H}x{EVAL_W} through gather_rows_linear vs plain: "
         f"{int((mask != plain).sum())} pixels differ; {share:.1%} occluded")
    if tl.gather_rows_linear.launches != before + 1 or not torch.equal(mask, plain) \
            or not 0.0 < share < 1.0:
        raise AssertionError("occ_mask through the kernel and through its plain version differ")


def _check_liif_modes(torch):
    """One full-size eval forward each with 4-nearest latents and with the
    local ensemble: finite, of the input's size."""
    from anystereo_tpu_torch.config import LiifConfig
    from anystereo_tpu_torch.nn.model import build_model

    left, right = _images(torch, 1)
    for kw in (dict(quarter_nearest="both"), dict(local_ensemble=True)):
        model = build_model(_config("igev", liif=LiifConfig(**kw)), device=DEVICE, seed=0)
        disp = model(left, right, iters=CHECK_ITERS).disp_final
        torch.cuda.synchronize()
        _log(f"[check] IGEV eval forward with {kw}: disp_final {tuple(disp.shape)}, range "
             f"[{float(disp.min()):.3f}, {float(disp.max()):.3f}] px")
        if tuple(disp.shape) != (1, H, W) or not bool(torch.isfinite(disp).all()):
            raise AssertionError(f"eval forward with {kw}: {tuple(disp.shape)} not finite [1, {H}, {W}]")
        del model
        torch.cuda.empty_cache()


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


def phase_check(torch, kernels):
    """fp32 without TF32, and cuDNN held to its deterministic algorithms: its
    other backward algorithms sum with atomics, and two runs of one and the
    same path then differ by up to 1e-2 relative in the cost aggregation's
    gradients (measured on the H100), which would hide the kernels' 5e-6."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    for core in ("igev", "raft"):
        _check_eval(torch, kernels, core)
        torch.cuda.empty_cache()
    _check_occlusion(torch)
    for core, flavor in (("igev", "aligned"), ("igev", "levels"), ("raft", "classify")):
        _check_train(torch, kernels, core, flavor)
        torch.cuda.empty_cache()
    _check_liif_modes(torch)


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
    def forward():
        return model(left, right, iters=ITERS)

    prof_wall, kernel_ms, kernel_n, table, named = _profiled(torch, forward)
    summary = {"stages_ms": totals, "stages_wall_ms": wall, "forward_wall_ms": prof_wall,
               "kernel_ms": kernel_ms, "kernel_launches": kernel_n,
               "busy_share": kernel_ms / prof_wall,
               "b1_fwd_ms": _named_ms(named, "pyr_aligned_fwd")}
    if PARENT:
        summary["b1_fwd_ms_in_turns"] = _b1_in_path(torch, forward)
    IN_PATH["eval forward"] = {k: summary[k] for k in ("b1_fwd_ms", "b1_fwd_ms_in_turns") if k in summary}
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "profile_forward.txt")
    with open(path, "w") as f:
        f.write(json.dumps(summary) + "\n" + table)
    _log(f"[profile] {json.dumps(summary)}; kernel table in {path}")
    _log(table)


def _profiled(torch, fn):
    """Run `fn` under torch.profiler: (wall ms, summed kernel ms, kernel
    launches, the table of kernels by device time, {kernel name: ms})."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    kernel_us, kernel_n, named = 0.0, 0, {}
    for ev in averages:
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        if us > 0:
            kernel_us, kernel_n = kernel_us + us, kernel_n + ev.count
            named[ev.key] = named.get(ev.key, 0.0) + us / 1e3
    return wall, kernel_us / 1e3, kernel_n, averages.table(sort_by="cuda_time_total", row_limit=40), named


def _named_ms(named, part):
    """Device ms of the kernels whose name holds `part`."""
    return sum(ms for key, ms in named.items() if part in key)


def _b1_in_path(torch, fn):
    """B1's forward summed over one run of `fn` under torch.profiler (ms), in
    turns this tree, parent, parent, this tree, with the parent's kernel
    swapped into the wrapper: each kernel inside the path, with L2 as the
    path's other kernels leave it."""
    from anystereo_tpu_torch.ops.kernels import lookup

    own = lookup._kernel
    turns = {"this": [], "parent": []}
    for who in ("this", "parent", "parent", "this"):
        if who == "parent":
            lookup._kernel = lambda backward=False: own(True) if backward else PARENT["lookup_aligned"]
        try:
            turns[who].append(_named_ms(_profiled(torch, fn)[4], "pyr_aligned_fwd"))
        finally:
            lookup._kernel = own
    return turns


def _beside_parent_line(records):
    """One short line of the times (ms) that --parent and --profile add, so
    that they stay in a log that keeps only the end of the output."""
    def r(v):
        return [round(t, 5) for t in v] if isinstance(v, list) else round(v, 5)

    out = {}
    for rec in records:
        if rec["name"] == "gather_pyramid_aligned":
            for c in rec["per_call"]:
                out[f"B1 {c['call']}"] = {k: r(c[k]) for k in (
                    "ms", "ms_beside_parent", "parent_ms", "ms_path", "ms_path_beside_parent", "parent_ms_path",
                    "floor_ms", "plain_ms", "copy_ms", "bound_ms", "bound_ms_path")}
        elif rec["name"] == "scatter_rows_add":
            for c in rec["per_call"]:
                out[f"B2 C={c['table'][2]}"] = {k: r(c[k]) for k in (
                    "ms", "ms_beside_parent", "parent_ms", "floor_ms", "plain_ms", "library_ms", "bound_ms")}
    for path, times in IN_PATH.items():
        out[f"B1 in the {path}"] = {k: ({w: r(t) for w, t in v.items()} if isinstance(v, dict) else r(v))
                                    for k, v in times.items()}
    return "[beside parent] " + json.dumps(out, separators=(",", ":"))


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
    prof_wall, kernel_ms, kernel_n, table, named = _profiled(torch, lambda: step(state, batch))
    summary = {"stages_ms": stages, "stages_wall_ms": wall, "step_wall_ms": prof_wall,
               "kernel_ms": kernel_ms, "kernel_launches": kernel_n,
               "busy_share": kernel_ms / prof_wall,
               "b1_fwd_ms": _named_ms(named, "pyr_aligned_fwd"),
               "b1_bwd_ms": _named_ms(named, "pyr_aligned_bwd")}
    if PARENT:
        summary["b1_fwd_ms_in_turns"] = _b1_in_path(torch, lambda: step(state, batch))
    IN_PATH["training step"] = {k: summary[k] for k in ("b1_fwd_ms", "b1_fwd_ms_in_turns") if k in summary}
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
    from anystereo_tpu_torch.ops.kernels import lookup_linear as tl
    from anystereo_tpu_torch.ops.kernels import lookup_window as tw
    from anystereo_tpu_torch.ops.kernels.gather import gather_rows, scatter_rows_add
    from anystereo_tpu_torch.ops.kernels.lookup import (
        gather_pyramid_aligned,
        gather_pyramid_aligned_bwd,
    )

    # every wrapper that counts launches; the main paths reach the first nine
    kernels = [gather_pyramid_aligned, gather_pyramid_aligned_bwd, tw.gather_pyramid_window_pm,
               tw.gather_pyramid_window_pm_bwd, gather_rows, scatter_rows_add,
               tl.gather_window_linear, tl.gather_window_linear_bwd, tl.gather_rows_linear,
               tl.gather_rows_linear_bwd, tw.gather_pyramid_window_t, tw.gather_pyramid_window_t_bwd,
               tw.gather_pyramid_window, tw.gather_pyramid_window_bwd]
    profile = "--profile" in argv
    parent = argv[argv.index("--parent") + 1] if "--parent" in argv else None
    card = _card()
    _log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
         f"CUDA {torch.version.cuda}; nvidia-smi: {card}")
    phase_build(parent)
    records = phase_kernels(torch)
    by_path = {}
    by_path["eval_igev"], model = phase_model(torch, kernels, "igev", "aligned", keep=profile)
    if profile:
        phase_profile(torch, model)
    del model
    torch.cuda.empty_cache()
    by_path["eval_raft"], _ = phase_model(torch, kernels, "raft", "aligned")
    torch.cuda.empty_cache()
    classify, _ = phase_model(torch, kernels, "raft", "classify")
    by_path["eval_raft"] = {k: v + classify[k] for k, v in by_path["eval_raft"].items()}
    torch.cuda.empty_cache()
    by_path["eval_levels"], _ = phase_model(torch, kernels, "igev", "levels")
    torch.cuda.empty_cache()
    raft_levels, _ = phase_model(torch, kernels, "raft", "levels")
    by_path["eval_levels"] = {k: v + raft_levels[k] for k, v in by_path["eval_levels"].items()}
    torch.cuda.empty_cache()
    _log("[model] ms per pair by lookup flavor: " + "; ".join(
        f"{core.upper()} " + ", ".join(f"{fl} {ms:.2f}" for (c, fl), ms in PAIR_MS.items() if c == core)
        for core in ("igev", "raft")))
    by_path["validate"] = phase_validate(torch, kernels)
    torch.cuda.empty_cache()
    by_path["train_igev"], trained = phase_train(torch, kernels, "igev", "aligned")
    if profile:
        phase_profile_train(torch, *trained)
    del trained
    torch.cuda.empty_cache()
    by_path["train_raft"], trained = phase_train(torch, kernels, "raft", "classify")
    del trained
    torch.cuda.empty_cache()
    by_path["train_levels"], trained = phase_train(torch, kernels, "igev", "levels", steps=1)
    del trained
    torch.cuda.empty_cache()
    phase_check(torch, kernels)
    if "--spread" in argv:
        phase_spread(torch)
    for record in records:
        name = record["name"]
        if record["paths"] == ["op"]:
            # reached only as a public function: launched and held in the
            # kernels phase, on no system path
            record["launches_by_path"] = {"op": record["op_launches"]}
        else:
            record["launches_by_path"] = {path: by_path[path][name] for path in by_path}
            idle = [path for path in record["paths"] if by_path[path][name] == 0]
            if idle:
                raise AssertionError(f"{name} never launched on {idle}: {record['launches_by_path']}")
        record["launches"] = sum(record["launches_by_path"].values())
        if record["launches"] == 0:
            raise AssertionError(f"{name} was never launched: {record['launches_by_path']}")
    print(json.dumps({"kernels": records}))
    if PARENT:
        _log(_beside_parent_line(records))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
