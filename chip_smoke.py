#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card (H100) and check it.

    python3 chip_smoke.py             # the phases below
    python3 chip_smoke.py --profile   # and time breakdowns of one eval
                                      # forward and one training step,
                                      # written to chiprun_out/, with the
                                      # aligned lookup's forward summed
                                      # inside both, and its backward, the
                                      # scatter-add and the row gather
                                      # inside the step; the window-pyramid
                                      # lookup's forward summed inside the
                                      # IGEV and RAFT eval forwards under
                                      # "classify", the window linear
                                      # lookup's inside the IGEV one under
                                      # "levels", its forward and
                                      # backward inside the IGEV training
                                      # step under "levels", the
                                      # window-pyramid lookup's forward and
                                      # backward inside the RAFT training
                                      # step under "classify", and the
                                      # aligned lookup's, the scatter-add's
                                      # and the gather's inside the IGEV
                                      # training step under remat
    python3 chip_smoke.py --spread    # and the run-to-run spread of the fp32
                                      # gradients with and without cuDNN's
                                      # deterministic algorithms
    python3 chip_smoke.py --parent DIR
                                      # and, in the kernels phase, the aligned
                                      # lookup's forward and backward, the
                                      # row gather, the scatter-add, the
                                      # window-pyramid lookup's forward and
                                      # backward, the window linear lookup's
                                      # forward and backward and the rows
                                      # linear lookup's forward and backward as
                                      # the checkout at DIR builds them (an
                                      # earlier commit): held to this tree's
                                      # (all but the scatter bit for bit) and
                                      # timed beside them, in turns (with
                                      # --profile also inside the paths)

Phases (any failure raises, and the exit code is not 0):

1. build   every `anystereo_tpu_torch/csrc/*.cu` with nvcc for sm_90a and
           the data path's host C sources (`csrc/*.c`: the PNG unfilter, the
           JPEG decoder, the resizes, the colour conversions and the PFM
           reader with the sparse rescale) with the host C compiler, all
           sources at once;
2. kernels each kernel against its plain PyTorch version on the card, at the
           shapes the main paths give it, with its time (CUDA events, L2
           flushed before each launch), the plain version's time, the time
           of the one PyTorch call that computes the same function (where
           there is one) and the least time the card could take: the aligned
           pyramid lookup's forward and backward (IGEV shapes at 2 levels,
           the forward also at the trainer's 544x960 SceneFlow validation,
           RAFT shapes at 4), the window-pyramid lookups in their three
           layouts, forward and backward, held to their plain versions bit
           for bit and to each other (the pixel-major forward and its
           backward, the "classify" flavor's, the transposed forward and the
           row-major backward also at path-shaped positions, with
           `floor_ms` and the read-flush time), the query row gather and its
           scatter-add transpose (the 9-tap disparity table and both latent
           tables, 51,200 queries a sample; the scatter also in PyTorch's
           deterministic mode, its sorted kernel repeating its bits),
           `gather_rows_hybrid`, and the
           single-level linear lookups, forward and backward, bit for bit:
           `gather_window_linear` at the eight level shapes of the "levels"
           flavor's eval forwards and the four of its training step,
           `gather_rows_linear` at the evaluator's occlusion shapes
           (375 rows of 1242 positions, SceneFlow's 540 of 960) and at
           300 x 312 x 9, each beside
           `grid_sample` (forward) and `grid_sampler_2d_backward`, the one
           PyTorch call that computes the same lerp (the window forward also
           at path-shaped starts; it, both backwards and the rows forward
           with `floor_ms` and the read-flush time).
           The aligned
           lookup's forward is held and timed at uniformly random positions
           and at path-shaped ones (a smooth disparity field), beside a
           PyTorch copy of as many bytes as its bound counts; it, its
           backward, the gather and the scatter-add carry `floor_ms`, the
           same wrapper's time on one row or one query; the backward and the
           gather are timed once more with the flush a read (L2 left clean),
           beside a one-element `zero_()` timed both ways (the launch);
3. model   the eval forward at full width, 1x384x1248, 32 GRU iterations,
           bf16, weights from a seeded generator, one warm-up and three timed
           requests each: the IGEV model (`ModelConfig()`), the RAFT model
           (`raft_config()`) under the "aligned" lookup flavor and under
           "classify", and both models under "levels" (path `eval_levels`);
           every kernel's launch count is read over exactly these requests;
4. bench   the bench entry point as a user runs it, `cli.main(["bench"])`
           (`anystereo_tpu_torch/bench.py`: the same forward, batch 1,
           384x1248, 32 iterations, bf16, images from RandomState(0)), in
           this process with its output captured: exit 0 (its chained
           output within its band of the direct one), one JSON line with
           every key, pairs/s and both latencies finite and positive, the
           card named; B1 64 a forward, exactly, over the 25 forwards it
           makes, no other kernel; then `utils/profiling.flops_estimate` of
           one forward, and `latency_ms` and `latency_ms_e2e` beside the
           model phase's ms a pair, the achieved TFLOP/s and its share of
           the card's bf16 peak;
5. validate `validate_dataset` on a seeded in-memory dataset of three
           375x1242 frames with left and right ground truth (IGEV model, 32
           iterations, bf16, padded to 384x1248 by the evaluator, the
           left-right occlusion split), then `Validator.infer` with
           `fixed_upscale=2` on a 188x624 pair and with `scale_test=2.0` on a
           375x1242 pair; ms per frame and the host's share of it;
6. train   the training step at full width (`TrainConfig()`: batch 2,
           160x320, 51,200 queries a sample, 16 iterations with a query decode
           each, bf16, sequence loss, clip, AdamW) on a seeded synthetic
           batch, one warm-up and three timed steps with the exact launch
           counts of each: the IGEV model ("aligned"), the same with
           `ModelConfig(remat=True)` (path `train_remat`: the backward runs
           each iteration's body again, so per step B1 64 + 32 and gather 96,
           scatter 48), its ms a step and peak memory beside the plain
           step's, and the RAFT model ("classify"); one timed step of the
           IGEV model under "levels";
7. trainer training from dataset files: a SceneFlow tree (8 + 2 pairs of
           540x960 PNGs with left and right PFM disparities) and a KITTI
           2015 tree (2 frames of 375x1242, 16-bit disparity PNGs) written
           by the port's writers, and a FallingThings tree (3 frames, each
           the committed 540x960 JPEG pair of `tests/data/jpeg/` and a
           16-bit depth PNG; the left view of temple_4/000000 the committed
           progressive JPEG of the same view, `tests/data/formats/`); first
           the readers line: the C PNG unfilter beside the plain numpy one
           on both PNG kinds, None- and Paeth-filtered, and on the SceneFlow
           frame written Adam7-interlaced, the C JPEG decode of the
           committed 540x960 baseline and progressive files and, at that
           size, of the progressive file cut short (smoothed) and of
           arithmetic-coded and lossless files written there, every
           committed JPEG and every file of `tests/data/formats/` (PNG,
           JPEG and PPM of every form) held to its recorded PIL digest and
           every one OpenCV reads to its recorded `read_disp_kitti`
           (OpenCV's) digest, and the host compiler's version; the augment line: each host C function
           of the augmentor at the path's shapes (the uint8 and float32
           bilinear resizes of a 540x960 frame and its flow by a stretched
           scale, the bicubic 400x800 -> 160x320, gray, RGB->HSV and
           HSV->RGB on the 1080x960 stacked pair, a 540x960 PFM read, the
           sparse rescale of a 375x1242 KITTI disparity) held to its plain
           numpy version bit for bit and timed beside it, then one SceneFlow
           (multi-scale) and one KITTI (sparse) sample through
           `StereoDataset.__getitem__` on the C path and on the plain path
           from one seed, every array identical; then `fetch_dataset(["sceneflow",
           "falling_things"])` (FallingThings x 5, every image decoded by
           the C readers inside the loader's threads) in
           multi-scale mode at `TrainConfig()` defaults, `PrefetchLoader`
           (batch 2, 4 workers, seed 1234), `train()` for 4 steps with a
           checkpoint and a 2-frame SceneFlow validation every 2 steps, a
           second `train()` that resumes at step 4 and runs to 6 (its first
           state bit for bit the saved one, its learning rates the straight
           schedule's), a checkpoint restored on the card and on the CPU,
           and `run_validation` of the checkpoint on SceneFlow (within 1e-3
           px of the last in-training EPE) and KITTI 2015; exact launches
           per step (B1 32 + 32, gather 48, scatter 48) and per validation
           frame (B1 64, B8 1 on SceneFlow); the JPEGs and PNGs `train()`
           decoded; the loader's samples/s with 2 and with 4 samples in
           flight, and one SceneFlow and one FallingThings sample alone; the
           trees stay for the phases after it;
8. loader  the checkpointable loader (`data/grain_loader.py`) on the same
           trees and `fetch_dataset` mix: `GrainLoader` (4 worker
           processes, seed 1234) through `train()` straight for 4 steps with
           a checkpoint every 2, and a run preempted at step 2 (its
           `loader_state-2-p0.bin` written) that a fresh `train()` resumes
           to 4: its first state bit for bit the saved one, the digest of
           every batch steps 3-4 consumed the straight run's, exact
           launches per step (B1 32 + 32, gather 48, scatter 48); then
           `cli.main(["train", "--loader", "grain", ...])` for 2 steps (exit
           0, its loader state written); the loader's samples/s alone
           beside the trainer phase's `PrefetchLoader` figure;
9. convert a seeded reference-format IGEV checkpoint at `ModelConfig()`
           widths (keys and shapes from `tests/data/reference_keys_igev.json`,
           `module.` prefix, `{"model": ...}` wrapper) through `python -m
           anystereo_tpu_torch.tools.convert_checkpoint --verify`, loaded
           strictly into a reference-regime model and validated on the KITTI
           tree (B1 64 a frame); the conversion's ms and tensor count;
10. cli    `cli.main(["train", ..., "--restore", <converted>])` for 2 steps
           at `TrainConfig()` defaults on the SceneFlow tree (per step B1 32
           + 32, gather 48, scatter 48; the CLI builds the GroupNorm model,
           so the converted checkpoint's BatchNorm tensors are not loaded,
           and the warning that says so must come), `cli.main(["evaluate", ...])` of its
           checkpoint on SceneFlow (B1 64 and B8 1 a frame), and a `python -m
           anystereo_tpu_torch.cli evaluate` subprocess on KITTI that must
           exit 0 and print its metrics;
11. ddp    two ranks on the one card (`torch.multiprocessing`, gloo), each
           with one sample of a seeded batch of two whose valid counts
           differ, one fp32 `train()` step at full width against one process
           on the batch of two: loss, gradients, parameters, ms per step,
           each rank's launches sent back;
12. spatial two ranks on the one card (gloo) tile the rows of a 1504x2016
           frame (`infer_spatial_sharded`, IGEV `ModelConfig()`, bf16, 32
           iterations): one warm-up and three dense requests and one at
           200,000 scattered queries, against the same in one process: ms a
           request, each rank's peak memory (under 0.7 of the one
           process's), the collectives a request and their summed time,
           exact launches (B1 64 a request on each rank, the row gather 3 at
           the queries), the bf16 outputs within the JAX package's band of
           its sharded forward (|d| <= 0.05 + 0.05 |ref|; the median under
           0.2 px, a bound that a planted fault, the rows computed in reverse
           order, must exceed) and an fp32 check at 384x1248 (4 iterations)
           within 1e-3 px;
13. tools  the port's tools as a user runs them (`anystereo_tpu_torch/tools/`,
           each `main` in this process): `make_synthetic_datasets` writes
           the SceneFlow, KITTI, Middlebury and ETH3D trees at seed 0 (nine
           protocols resolve); `check_datasets --smoke` on them (an eval
           smoke, a 20-step CLI train smoke in a subprocess); `e2e_demo` at
           the JAX gate's recipe (150 steps at lr 2e-4, `supervise_init`,
           PyTorch's deterministic algorithms, so the run repeats from its
           seed) must print E2E PASS, a held-out EPE under 2.1 px, with its
           ms a step; `overfit_sanity` (400 steps on one batch) must print
           LEARNED; `reproduce_baseline` rehearses the 100k-step recipe for
           20 steps and writes a row for each of the nine protocols naming
           the card; `scaling_bench --devices 1`; exact launches stage by
           stage (per step B1 2 + 2, gather 3, scatter 3 an iteration; B1 2
           an iteration a frame); its line also goes to
           `chiprun_out/tools.txt` and each tool's output to
           `chiprun_out/tools_<name>.txt`;
14. check  fp32 (TF32 off, cuDNN deterministic), 4 iterations: the IGEV and
           RAFT eval forwards through the kernels against the same with every
           lookup forced to its plain version, under each flavor, and the
           flavors against "aligned"; the occlusion mask through the kernel
           against its plain version; a training loss and every parameter's
           gradient (batch 1, 4,096 queries) through the kernels and with
           every kernel forced to its plain version, IGEV under "aligned" and
           under "levels", RAFT under "classify"; the IGEV training loss and
           gradients of the train phase's step (`TrainConfig()`, its batch)
           with `remat` against the same without, both through the kernels;
           one forward each with `quarter_nearest="both"` and with
           `local_ensemble=True`.

It prints a `kernels` JSON line (also written to kernels.json in OUT_DIR),
with `--parent` a short line of the redesigned kernels' times beside the
parent's (and, with `--profile`, their sums inside the paths), the card's
name and power limit as nvidia-smi reports them, and last
`{"ok": true, "device": {...}}`.  It
exits with code 2 and prints no result when no CUDA card is visible.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
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
LIBRARY_ATOL = 1e-3  # grid_sample against the linear lookups, unit-normal volumes (`_library_atol`)
MODEL_CHECK_ATOL = 1e-3  # px, fp32 forward, kernel vs plain lookup
TRAIN_BATCH, TRAIN_H, TRAIN_W, TRAIN_SHIFT = 2, 160, 320, 6  # TrainConfig(): batch, inp_size; px of disparity
TRAIN_STEPS = 3
EVAL_H, EVAL_W, EVAL_FRAMES = 375, 1242, 3  # KITTI-sized frames of the validate path
SCATTER_RTOL = 1e-5  # |kernel - plain| <= rtol * (1 + sum_q |g[q, c]| of that element): atomic order
GRAD_CHECK_RTOL, GRAD_CHECK_ATOL, LOSS_CHECK_RTOL = 1e-3, 1e-7, 1e-5
OUT_DIR = "chiprun_out"
DEVICE = "cuda"
PARENT = {}  # --parent: source name -> library built from an earlier checkout's source
PAIR_MS = {}  # (core, flavor) -> mean ms per pair of the timed eval requests
STEP_MS = {}  # (core, flavor, remat) -> (mean ms per timed training step, peak GiB)
IN_PATH = {}  # --profile: B1-B3 summed inside the profiled forward and step
YARDSTICK = {}  # the kernels phase: one launch between the event pair (`_yardstick`)


def _log(*a):
    print(*a, flush=True)


def _card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    from anystereo_tpu_torch.utils.device import describe_device

    return describe_device("cuda:0")


# ----------------------------------------------------------------- phase 1


PARENT_SOURCES = ("lookup_aligned", "gather_rows", "lookup_window", "lookup_linear")


def phase_build(parent=None):
    """Every source of this tree, and with `parent` (a checkout's root) that
    checkout's sources of the redesigned kernels, all at once."""
    from anystereo_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    procs = []
    for name in PARENT_SOURCES if parent else ():
        out = build.BUILD_DIR / f"libparent_{name}.so"
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = os.path.join(parent, "anystereo_tpu_torch", "csrc", f"{name}.cu")
        procs.append((name, out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    # the CUDA sources and the data path's host C sources, all started together
    seconds = build.build(sorted(p.stem for p in build.CSRC.glob("*.cu")) +
                          sorted(p.stem for p in build.CSRC.glob("*.c")))
    for name, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n{log}")
        PARENT[name] = ctypes.CDLL(str(out))
    for name, log in build.BUILD_LOGS.items():
        if log.strip():
            _log(f"[build] {name} compiler output:\n{log.strip()}")
    _log(f"[build] {sorted(seconds)} built in {time.perf_counter() - t0:.2f} s "
         f"(per source: {json.dumps({k: round(v, 2) for k, v in seconds.items()})})")


@contextlib.contextmanager
def _parent_kernels():
    """This tree's wrappers with the parent's libraries (`PARENT_SOURCES`)
    swapped in, launches counted as this tree's.  The C entry points of
    those sources keep their signatures across the redesigns."""
    from anystereo_tpu_torch.ops.kernels import build

    own = build.load_library
    build.load_library = lambda name: PARENT[name] if name in PARENT else own(name)
    try:
        yield
    finally:
        build.load_library = own


def _as_parent(fn):
    def run():
        with _parent_kernels():
            return fn()
    return run


def _beside_parent(torch, res, key, fn):
    """Times in turns, parent, this tree, this tree, parent: `parent_<key>`
    and `<key>_beside_parent`, two each."""
    parent_fn = _as_parent(fn)
    p1, n1, n2, p2 = (_time_ms(torch, f) for f in (parent_fn, fn, fn, parent_fn))
    res[f"parent_{key}"], res[f"{key}_beside_parent"] = [p1, p2], [n1, n2]


# ----------------------------------------------------------------- phase 2


def _time_ms(torch, fn, reps=20, warmup=3, read_flush=False):
    """Median device time of `fn` by CUDA events, with a 256 MB write before
    each launch so the volumes are not left in the 50 MB L2 (in the GRU loop
    the update block runs between two lookups).  64 such writes (~5 ms) are
    queued first, so the host runs ahead of the card and the events enclose
    the kernel, not the host's time in the wrapper.  `read_flush`: the flush
    is a read of the 256 MB (`sum`), which leaves L2 as full but of clean
    lines, so the timed launch evicts without writing back."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=DEVICE)
    flush_once = flush.sum if read_flush else flush.zero_
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for _ in range(64):
        flush_once()
    for s, e in ev:
        flush_once()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in ev)
    return times[len(times) // 2]


def _yardstick(torch):
    """What a timed launch costs before the kernel's own work: one launch of
    a one-element `zero_()` between the event pair, after either flush."""
    one = torch.empty(1, device=DEVICE)
    YARDSTICK["launch_ms"] = _time_ms(torch, one.zero_)
    YARDSTICK["launch_ms_clean"] = _time_ms(torch, one.zero_, read_flush=True)
    _log(f"[kernels] launch yardstick: a one-element zero_() {YARDSTICK['launch_ms']:.4f} ms after the "
         f"write flush, {YARDSTICK['launch_ms_clean']:.4f} ms after the read flush")


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


def _window_cost(torch, bases, length, transposed, sectors=False):
    """The same for the window lookups, from the window starts `bases`
    [R, levels]: bases and the fp32 output once, and of the volume the
    entries inside some window; in the [L, R] layout whole 32-byte sectors
    (8 neighbouring rows of one entry), the least the card can fetch.  In
    the [R, L] layout 4 bytes an entry, or with `sectors` whole sectors
    there too (8 neighbouring entries of the flattened volume, which starts
    on a sector)."""
    rows, levels = bases.shape
    starts = torch.floor(bases).clamp(-(TAPS + 1), length).long()
    need = _window_need(torch, starts, length, levels)
    if transposed:
        pad = (-rows) % 8
        need = torch.nn.functional.pad(need.to(torch.uint8), (0, 0, 0, pad))
        vol_bytes = 32 * int(need.reshape(-1, 8, length).any(dim=1).sum())
    elif sectors:
        flat = need.reshape(-1).to(torch.uint8)
        flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % 8))
        vol_bytes = 32 * int(flat.reshape(-1, 8).any(dim=1).sum())
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
    the training size (batch 2, 40x80 cells); the IGEV pair of the
    trainer's SceneFlow validation (batch 1, 136x240 cells); and the IGEV
    pair of the spatial path's larger tile (the first rank's 768 of 1504
    rows at 2016 columns: 192x504 cells)."""
    h4, w4, groups, d = H // 4, W // 4, 8, 192 // 4
    cells, tw4 = 2 * (TRAIN_H // 4) * (TRAIN_W // 4), TRAIN_W // 4
    sh4, sw4 = _sf_cells()
    th4, tw4_tile = _tile_cells()
    return (("gev", h4 * w4 * groups, d, IGEV_LEVELS), ("corr", h4 * w4, w4, IGEV_LEVELS),
            ("train_gev", cells * groups, d, IGEV_LEVELS), ("train_corr", cells, tw4, IGEV_LEVELS),
            ("raft_corr", h4 * w4, w4, RAFT_LEVELS), ("raft_train_corr", cells, tw4, RAFT_LEVELS),
            ("sf_gev", sh4 * sw4 * groups, d, IGEV_LEVELS), ("sf_corr", sh4 * sw4, sw4, IGEV_LEVELS),
            ("tile_gev", th4 * tw4_tile * groups, d, IGEV_LEVELS),
            ("tile_corr", th4 * tw4_tile, tw4_tile, IGEV_LEVELS))


def _tile_cells():
    """The correlation cells of the spatial path's larger tile (the first
    rank's rows of SPATIAL_H over SPATIAL_RANKS ranks), at a quarter."""
    from anystereo_tpu_torch.parallel.spatial import row_partition

    bounds = row_partition(SPATIAL_H, SPATIAL_RANKS)
    return (bounds[1] - bounds[0]) // 4, SPATIAL_W // 4


def _sf_cells():
    """The correlation cells of a SceneFlow frame in validation: 540x960
    padded to a multiple of 32 (544x960), at a quarter."""
    return -(-SF_H // 32) * 8, -(-SF_W // 32) * 8


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
    d over the cells (4 to 40 cells; eval 1x96x312, training 2x40x80,
    SceneFlow validation 1x136x240, the spatial tile 1x192x504); the
    GEV volume has one x = d for each run of 8 consecutive rows (a cell's
    groups), the correlation x = column - d."""
    import math

    if "train" in call:
        batch, h4, w4 = TRAIN_BATCH, TRAIN_H // 4, TRAIN_W // 4
    elif call.startswith("sf_"):
        batch, (h4, w4) = 1, _sf_cells()
    else:
        batch, (h4, w4) = 1, _tile_cells() if call.startswith("tile_") else (H // 4, W // 4)
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
            parent = _as_parent(lambda: gather_pyramid_aligned(vol, x, TAPS, levels, out_dtype))()
            if not torch.equal(got, parent):
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
                _beside_parent(torch, res, key, lambda: gather_pyramid_aligned(vol, pos, TAPS, levels, bf16))
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
                   paths=("eval_igev", "bench", "train_igev", "train_remat", "eval_raft", "trainer", "loader",
                          "convert", "cli", "ddp", "spatial", "tools"))


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
            if PARENT:
                if not torch.equal(got, _as_parent(lambda: gather_pyramid_aligned_bwd(x, g, length, TAPS, levels))()):
                    raise AssertionError(f"lookup backward {call} {g.dtype}: differs from the parent's kernel")
                res["equal_to_parent"] = True
        g = g32.bfloat16()  # the main path's cotangent is bf16
        fn = (lambda: gather_pyramid_aligned_bwd(x_main, g, length, TAPS, levels))
        one = (lambda: gather_pyramid_aligned_bwd(x_main[:1], g[:1], length, TAPS, levels))
        res["ms"], res["floor_ms"] = _time_ms(torch, fn), _time_ms(torch, one)
        res["ms_clean"], res["floor_ms_clean"] = (_time_ms(torch, f, read_flush=True) for f in (fn, one))
        if PARENT:
            _beside_parent(torch, res, "ms", fn)
        res["plain_ms"] = _time_ms(torch, lambda: gather_pyramid_aligned_bwd_ref(
            x_main, g, length, TAPS, levels), reps=5)
        # what autograd does with each iteration's dvol after the kernel: add
        # it into the volume's gradient (15 such adds a volume and step)
        dvol, acc = fn(), torch.zeros(rows, length, device=DEVICE)
        res["accumulate_ms"] = _time_ms(torch, lambda: acc.add_(dvol))
        del dvol, acc
        # g and x read once, the whole of dvol written once; per row a
        # product and a sum per tap side, a scale and a sum per entry and level
        res["bytes"] = rows * (levels * TAPS * 2 + 4 + length * 4)
        res["flops"] = rows * levels * (4 * TAPS + 2 * length)
        res["bound_ms"], res["bound_by"] = _bound(res["bytes"], res["flops"])
        parent = "" if not PARENT else (
            f"; parent {res['parent_ms']} / this tree {res['ms_beside_parent']} ms in turns; equal to the "
            f"parent's output bit for bit")
        _log(f"[kernels] gather_pyramid_aligned_bwd {call} R={rows} L={length} levels={levels}: "
             f"max|diff| {res['max_abs_err']:.3g}; kernel {res['ms']:.4f} ms (read flush "
             f"{res['ms_clean']:.4f}), floor {res['floor_ms']:.4f} ms ({res['floor_ms_clean']:.4f}), plain "
             f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bytes']} B); adding dvol into "
             f"a gradient {res['accumulate_ms']:.4f} ms{parent}")
        calls.append(res)
    return _record("gather_pyramid_aligned_bwd", "anystereo_tpu_torch/csrc/lookup_aligned.cu",
                   "anystereo_tpu/ops/pallas/lookup_kernel.py:965", calls, main=(0, 1),
                   paths=("train_igev", "train_remat", "trainer", "loader", "cli", "ddp", "tools"))


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
    shapes = [c for c in _lookup_shapes() if not c[0].startswith("sf_")]  # "aligned" only there
    for call, rows, length, levels in shapes:
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
                sectors = ""
                if not vol_t and not tag:  # B6's forward: its bound in whole sectors as well,
                    # and a PyTorch copy that reads and writes as many bytes in all,
                    # after either flush
                    res["bytes_sectors"] = _window_cost(torch, bases_main, length, False, sectors=True)[0]
                    res["bound_ms_sectors"] = _bound(res["bytes_sectors"], flops)[0]
                    copy_in = torch.empty(res["bytes_sectors"] // 8, device=DEVICE)
                    copy_out = torch.empty_like(copy_in)
                    res["copy_ms"] = _time_ms(torch, lambda: copy_out.copy_(copy_in))
                    res["copy_ms_clean"] = _time_ms(torch, lambda: copy_out.copy_(copy_in), read_flush=True)
                    del copy_in, copy_out
                    sectors = (f"; in whole sectors {res['bound_ms_sectors']:.4f} ms ({res['bytes_sectors']} B; "
                               f"a copy of as many bytes {res['copy_ms']:.4f} ms, read flush "
                               f"{res['copy_ms_clean']:.4f} ms)")
                _log(f"[kernels] {name}{tag} {call} R={rows} L={length} levels={levels}: exact; "
                     f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, bound "
                     f"{res['bound_ms']:.4f} ms ({nbytes} B){sectors}")
                calls[name + tag].append(res)
        base_out, base_grad = results["gather_pyramid_window_pm"]
        for name, (o, d) in results.items():
            if not (torch.equal(o, base_out) and torch.equal(d, base_grad)):
                raise AssertionError(f"{name} {call}: differs from gather_pyramid_window_pm on the "
                                     "same operands in its layout")
        # B4, the "classify" flavor's lookup: path-shaped starts, the read
        # flush, one row, the parent; forward, then backward
        vol_t = vol.t().contiguous()
        bases_path = _path_positions(torch, call, rows)[:, None] * scales - radius
        starts = {k: b.t().contiguous() for k, b in
                  (("check", bases), ("main", bases_main), ("path", bases_path))}
        v1, b1 = vol_t[:, :1].contiguous(), starts["main"][:, :1].contiguous()
        _kernel_beside(torch, calls["gather_pyramid_window_pm"][-1], "gather_pyramid_window_pm",
                       lambda: tw.gather_pyramid_window_pm(vol_t, starts["main"], TAPS),
                       lambda: tw.gather_pyramid_window_pm(vol_t, starts["check"], TAPS),
                       lambda: tw.gather_pyramid_window_pm(v1, b1, TAPS),
                       path=(lambda: tw.gather_pyramid_window_pm(vol_t, starts["path"], TAPS),
                             lambda: tw.gather_pyramid_window_pm_ref(vol_t, starts["path"], TAPS),
                             _window_cost(torch, bases_path, length, True)[0]))
        # and its backward (B5's is the same kernel): the bound's bytes, the
        # whole of dvol written, do not depend on the positions
        cot1 = cot[:1].contiguous()
        _kernel_beside(torch, calls["gather_pyramid_window_pm_bwd"][-1], "gather_pyramid_window_pm_bwd",
                       lambda: tw.gather_pyramid_window_pm_bwd(starts["main"], cot, length, TAPS),
                       lambda: tw.gather_pyramid_window_pm_bwd(starts["check"], cot, length, TAPS),
                       lambda: tw.gather_pyramid_window_pm_bwd(b1, cot1, length, TAPS),
                       path=(lambda: tw.gather_pyramid_window_pm_bwd(starts["path"], cot, length, TAPS),
                             lambda: tw.gather_pyramid_window_pm_bwd_ref(starts["path"], cot, length, TAPS),
                             calls["gather_pyramid_window_pm_bwd"][-1]["bytes"]))
        # B5's forward (B4's staged walk, each tap stored as it is formed)
        # and B6's forward and backward (tiles of rows, the hulls staged; dvol
        # contiguous), the same way
        _kernel_beside(torch, calls["gather_pyramid_window_t"][-1], "gather_pyramid_window_t",
                       lambda: tw.gather_pyramid_window_t(vol_t, starts["main"], TAPS),
                       lambda: tw.gather_pyramid_window_t(vol_t, starts["check"], TAPS),
                       lambda: tw.gather_pyramid_window_t(v1, b1, TAPS),
                       path=(lambda: tw.gather_pyramid_window_t(vol_t, starts["path"], TAPS),
                             lambda: tw.gather_pyramid_window_t_ref(vol_t, starts["path"], TAPS),
                             _window_cost(torch, bases_path, length, True)[0]))
        rb1, rv1 = bases_main[:1].contiguous(), vol[:1].contiguous()
        b6 = calls["gather_pyramid_window"][-1]
        _kernel_beside(torch, b6, "gather_pyramid_window",
                       lambda: tw.gather_pyramid_window(vol, bases_main, TAPS),
                       lambda: tw.gather_pyramid_window(vol, bases, TAPS),
                       lambda: tw.gather_pyramid_window(rv1, rb1, TAPS),
                       path=(lambda: tw.gather_pyramid_window(vol, bases_path, TAPS),
                             lambda: tw.gather_pyramid_window_ref(vol, bases_path, TAPS),
                             _window_cost(torch, bases_path, length, False)[0]))
        b6["bytes_path_sectors"] = _window_cost(torch, bases_path, length, False, sectors=True)[0]
        b6["bound_ms_path_sectors"] = _bound(b6["bytes_path_sectors"], b6["flops"])[0]
        _kernel_beside(torch, calls["gather_pyramid_window_bwd"][-1], "gather_pyramid_window_bwd",
                       lambda: tw.gather_pyramid_window_bwd(bases_main, cot, length, TAPS),
                       lambda: tw.gather_pyramid_window_bwd(bases, cot, length, TAPS),
                       lambda: tw.gather_pyramid_window_bwd(rb1, cot1, length, TAPS),
                       path=(lambda: tw.gather_pyramid_window_bwd(bases_path, cot, length, TAPS),
                             lambda: tw.gather_pyramid_window_bwd_ref(bases_path, cot, length, TAPS),
                             calls["gather_pyramid_window_bwd"][-1]["bytes"]))
        del vol, vol_t, cot, results
    order = [c[0] for c in shapes]
    records = []
    for name, _, _, line_fwd, line_bwd, vol_t, out_t in layouts:
        system = name == "gather_pyramid_window_pm"
        for tag, line, main_call, paths in (
                ("", line_fwd, "raft_corr", ("eval_raft", "train_raft")),
                ("_bwd", line_bwd, "raft_train_corr", ("train_raft",))):
            records.append(_record(
                name + tag, src, f"anystereo_tpu/ops/pallas/lookup_kernel.py:{line}", calls[name + tag],
                main=(order.index(main_call),), paths=paths if system else ("op",)))
            if not vol_t and not tag:
                records[-1]["bound_ms_sectors"] = calls[name][order.index(main_call)]["bound_ms_sectors"]
    return records


def _kernel_beside(torch, res, what, fn, check, one, path=None):
    """A redesigned kernel (B4's, B6's and B7's forward and backward, B8's,
    B5's forward) beyond
    the common timing: `fn()` launches it at the timing's inputs, `check()`
    at the check's (far positions and collisions), `one()` on one row;
    `path`, where given, is (a launch at path-shaped inputs, its plain
    version, the bound's bytes there).  With --parent held to the
    parent's kernel bit for bit at each and timed in turns with it; timed
    after the read flush, on one row and at the path's inputs."""
    runs = (check, fn)
    if path is not None:
        at_path, plain, bytes_path = path
        got = at_path()
        torch.cuda.synchronize()
        if not torch.equal(got, plain()):
            raise AssertionError(f"{what} {res['call']}: differs from its plain version at path-shaped "
                                 "inputs")
        runs += (at_path,)
        res["ms_path"] = _time_ms(torch, at_path)
        res["bytes_path"] = bytes_path
        res["bound_ms_path"] = _bound(bytes_path, res["flops"])[0]
    if PARENT:
        for run in runs:
            if not torch.equal(run(), _as_parent(run)()):
                raise AssertionError(f"{what} {res['call']}: differs from the parent's kernel")
        res["equal_to_parent"] = True
        _beside_parent(torch, res, "ms", fn)
        if path is not None:
            _beside_parent(torch, res, "ms_path", path[0])
    res["ms_clean"] = _time_ms(torch, fn, read_flush=True)
    res["floor_ms"] = _time_ms(torch, one)
    parent = "" if not PARENT else (
        f"; parent {res['parent_ms']} / this tree {res['ms_beside_parent']} ms in turns, equal to "
        f"the parent's output bit for bit")
    if PARENT and path is not None:
        parent += (f"; path-shaped parent {res['parent_ms_path']} / this tree "
                   f"{res['ms_path_beside_parent']} ms")
    at_path = "" if path is None else (
        f"path-shaped {res['ms_path']:.4f} ms (bound {res['bound_ms_path']:.4f}), ")
    _log(f"[kernels] {what} {res['call']}: {at_path}read flush {res['ms_clean']:.4f} ms, floor "
         f"{res['floor_ms']:.4f} ms{parent}")


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
    queries a sample drawn with duplicates; and the gather alone at the
    spatial path's query decode (the larger tile's tables with their halo
    rows, its share of SPATIAL_QUERIES).  The gather is a copy and must be
    exact.  The scatter sums with atomics, so a row's sum is taken in another
    order than the plain version's: for each (row, channel),
    |diff| <= 1e-5 * (1 + the sum of |g| over the queries that land there).
    In PyTorch's deterministic mode the scatter is the ordered kernel
    (`_scatter_deterministic`): exact."""
    from anystereo_tpu_torch.ops.kernels.gather import (
        gather_rows,
        gather_rows_ref,
        scatter_rows_add,
        scatter_rows_add_ref,
        scatter_vec,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    fwd, bwd = [], []
    train = [(2, n, c, dtype, TRAIN_H * TRAIN_W) for n, c, dtype in (
        (3200, 9, torch.float32), (3200, 184, torch.bfloat16), (12800, 40, torch.bfloat16))]
    for batch, n, c, dtype, q in train + _tile_tables(torch):
        es = 4 if dtype == torch.float32 else 2
        table = torch.randn(batch, n, c, device=DEVICE, generator=gen).to(dtype)
        idx = torch.randint(0, n, (batch, q), device=DEVICE, generator=gen, dtype=torch.int32)
        g = torch.randn(batch, q, c, device=DEVICE, generator=gen).to(dtype)
        idx_long = idx.long()
        b_col = torch.arange(batch, device=DEVICE)[:, None]
        shape = {"table": [batch, n, c], "dtype": str(dtype).split(".")[-1], "queries": q}

        with torch.no_grad():
            # a few indices out of [0, n): the kernel writes zero rows for them
            bad = idx.clone()
            bad[:, :4] = torch.tensor([-1, n, -(2 ** 31), 2 ** 31 - 1], dtype=torch.int32, device=DEVICE)
            got, want = gather_rows(table, idx), gather_rows_ref(table, idx)
            got_bad = gather_rows(table, bad)
            torch.cuda.synchronize()
            if not torch.equal(got, want) or bool(got_bad[:, :4].any()) \
                    or not torch.equal(got_bad[:, 4:], want[:, 4:]):
                raise AssertionError(f"gather_rows {shape}: the kernel's rows differ from the table's")
            res = dict(shape, max_abs_err=0.0)
            if PARENT:
                if not torch.equal(_as_parent(lambda: gather_rows(table, idx))(), got):
                    raise AssertionError(f"gather_rows {shape}: differs from the parent's kernel")
                _beside_parent(torch, res, "ms", lambda: gather_rows(table, idx))
            fn = (lambda: gather_rows(table, idx))
            idx1 = idx[:, :1].contiguous()  # one query a sample, the same table
            one = (lambda: gather_rows(table, idx1))
            res["ms"], res["floor_ms"] = _time_ms(torch, fn), _time_ms(torch, one)
            res["ms_clean"], res["floor_ms_clean"] = (_time_ms(torch, f, read_flush=True) for f in (fn, one))
            res["plain_ms"] = _time_ms(torch, lambda: gather_rows_ref(table, idx))
            res["library_ms"] = _time_ms(torch, lambda: table[b_col, idx_long])
        res["bytes"], res["flops"] = idx.numel() * 4 + table.numel() * es + got.numel() * es, 0
        res["bound_ms"], res["bound_by"] = _bound(res["bytes"], 0)
        parent = "" if not PARENT else (
            f"; parent {res['parent_ms']} / this tree {res['ms_beside_parent']} ms in turns, equal")
        _log(f"[kernels] gather_rows {shape}: exact; kernel {res['ms']:.4f} ms (read flush "
             f"{res['ms_clean']:.4f}), floor {res['floor_ms']:.4f} ms ({res['floor_ms_clean']:.4f}), plain "
             f"{res['plain_ms']:.4f} ms, indexing {res['library_ms']:.4f} ms, bound "
             f"{res['bound_ms']:.4f} ms ({res['bytes']} B){parent}")
        fwd.append(res)
        if len(fwd) > len(train):  # the tiles' query decode takes no gradient
            del table, idx, bad, g, got, got_bad, want
            continue

        got, want = scatter_rows_add(idx, g, n), scatter_rows_add_ref(idx, g, n)
        row_abs = scatter_rows_add_ref(idx, g.abs(), n)  # per element: sum over its queries
        torch.cuda.synchronize()
        diff = (got - want).abs()
        if not bool((diff <= SCATTER_RTOL * (1.0 + row_abs)).all()):
            raise AssertionError(f"scatter_rows_add {shape}: max |kernel - plain| {float(diff.max())}")
        res = dict(shape, max_abs_err=float(diff.max()), vec=scatter_vec(c, dtype, g.data_ptr()))
        if PARENT:
            pdiff = (_as_parent(lambda: scatter_rows_add(idx, g, n))() - want).abs()
            if not bool((pdiff <= SCATTER_RTOL * (1.0 + row_abs)).all()):
                raise AssertionError(f"the parent's scatter_rows_add {shape}: max |diff| {float(pdiff.max())}")
            _beside_parent(torch, res, "ms", lambda: scatter_rows_add(idx, g, n))
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
        _scatter_deterministic(torch, res, idx, g, n, out, flat, g32)
        parent = "" if not PARENT else (
            f"; parent {res['parent_ms']} / this tree {res['ms_beside_parent']} ms in turns")
        det_parent = "" if not PARENT else (
            f"; parent {res['parent_deterministic_ms']} / this tree "
            f"{res['deterministic_ms_beside_parent']} ms in turns")
        _log(f"[kernels] scatter_rows_add {shape}: max|diff| {res['max_abs_err']:.3g}; kernel "
             f"{res['ms']:.4f} ms ({res['vec']} channels a lane), floor "
             f"{res['floor_ms']:.4f} ms, plain "
             f"{res['plain_ms']:.4f} ms, index_add_ {res['library_ms']:.4f} ms, bound "
             f"{res['bound_ms']:.4f} ms ({res['bytes']} B){parent}; deterministic mode (ordered kernel, "
             f"one launch and one kernel a call, bits repeated, exact against the plain version) "
             f"{res['deterministic_ms']:.4f} ms, index_add_ {res['deterministic_library_ms']:.4f} ms, bound "
             f"{res['deterministic_bound_ms']:.4f} ms{det_parent}")
        bwd.append(res)
        del table, idx, bad, g, got, got_bad, want, out, g32, idx1, g1
    src = "anystereo_tpu_torch/csrc/gather_rows.cu"
    # per decode all three tables go through the gather forward and the
    # scatter backward
    paths = ("train_igev", "train_remat", "train_raft", "trainer", "loader", "cli", "ddp", "tools")
    return [
        _record("gather_rows", src, "anystereo_tpu/ops/pallas/gather_kernel.py:319", fwd,
                main=(0, 1, 2), paths=paths + ("spatial",), library=True),
        dict(_record("scatter_rows_add", src, "anystereo_tpu/ops/pallas/gather_kernel.py:355", bwd,
                     main=(0, 1, 2), paths=paths, library=True),
             **{key: sum(c[key] for c in bwd) for key in (
                 "deterministic_ms", "deterministic_library_ms", "deterministic_bound_ms")},
             deterministic_max_abs_err=max(c["deterministic_max_abs_err"] for c in bwd)),
    ]


def _scatter_deterministic(torch, res, idx, g, n, out, flat, g32):
    """B2 in PyTorch's deterministic mode (the e2e demo's): the ordered
    kernel must repeat its bits and equal the plain version in that mode
    exactly (each row summed in ascending q), launch once a call and run as
    the one kernel of the call (no sort, no fill: the profiler's kernels
    over three calls); its time, its bound (the atomics kernel's bytes),
    `index_add_`'s in that mode, and with --parent the parent's in turns:
    its wrapper, or where its library has only the sorted kernel, that
    kernel after the parent wrapper's `torch.sort` and `searchsorted`."""
    from anystereo_tpu_torch.ops.kernels.gather import scatter_rows_add, scatter_rows_add_ref

    shape = res["table"]
    call = (lambda: scatter_rows_add(idx, g, n))
    torch.use_deterministic_algorithms(True)
    try:
        before = scatter_rows_add.launches
        got, again = call(), call()
        torch.cuda.synchronize()
        launched = scatter_rows_add.launches - before
        want = scatter_rows_add_ref(idx, g, n)
        _, _, kernels, _, _ = _profiled(torch, lambda: [call() for _ in range(3)],
                                        {"ordered": ("scatter_rows_ordered", scatter_rows_add)})
        res["deterministic_ms"] = _time_ms(torch, call)
        res["deterministic_library_ms"] = _time_ms(torch, lambda: out.zero_().index_add_(0, flat, g32))
        if PARENT:
            parent = _parent_deterministic(torch, idx, g, n)
            if not torch.equal(parent(), want):
                raise AssertionError(f"the parent's scatter_rows_add {shape}, deterministic mode, differs")
            p1, n1, n2, p2 = (_time_ms(torch, f) for f in (parent, call, call, parent))
            res["parent_deterministic_ms"], res["deterministic_ms_beside_parent"] = [p1, p2], [n1, n2]
    finally:
        torch.use_deterministic_algorithms(False)
    res["deterministic_max_abs_err"] = float((got - want).abs().max())
    if launched != 2 or kernels != 3 or not torch.equal(got, again) or not torch.equal(got, want):
        raise AssertionError(f"scatter_rows_add {shape}, deterministic mode: {launched} launches in 2 calls, "
                             f"{kernels} kernels in 3, repeats its bits {torch.equal(got, again)}, max "
                             f"|kernel - plain| {res['deterministic_max_abs_err']}")
    res["deterministic_bound_ms"] = res["bound_ms"]


def _parent_deterministic(torch, idx, g, n):
    """The parent's deterministic scatter-add, as its wrapper makes it."""
    from anystereo_tpu_torch.ops.kernels.gather import scatter_rows_add, scatter_vec

    lib = PARENT["gather_rows"]
    if hasattr(lib, "anystereo_scatter_rows_ordered"):
        return _as_parent(lambda: scatter_rows_add(idx, g, n))
    fn = lib.anystereo_scatter_rows_sorted
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    batch, q, c = g.shape
    vec, bf16 = scatter_vec(c, g.dtype, g.data_ptr()), int(g.dtype == torch.bfloat16)

    def run():
        key, order = torch.sort(idx, dim=1, stable=True)
        rows = torch.arange(n + 1, dtype=torch.int32, device=DEVICE).expand(batch, n + 1)
        start = torch.searchsorted(key, rows.contiguous(), out_int32=True)
        order = order.to(torch.int32)
        dtbl = torch.empty((batch, n, c), dtype=torch.float32, device=DEVICE)
        err = fn(order.data_ptr(), start.data_ptr(), g.data_ptr(), dtbl.data_ptr(), batch, n, q, c, bf16, vec,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the parent's scatter_rows_sorted failed: CUDA error {err}")
        return dtbl

    return run


def _tile_tables(torch):
    """(batch, rows, channels, dtype, queries) of the spatial path's query
    decode on its larger tile: the 9-tap disparity rows (fp32), the 1/4
    latent (bf16, 184 channels) and the 1/2 latent (bf16, 40 channels), each
    with GATHER_HALO rows past the tile on both sides, and the tile's share
    of SPATIAL_QUERIES (the first rank's rows over all)."""
    from anystereo_tpu_torch.parallel.spatial import GATHER_HALO, row_partition

    bounds = row_partition(SPATIAL_H, SPATIAL_RANKS)
    share = -(-SPATIAL_QUERIES * (bounds[1] - bounds[0]) // SPATIAL_H)
    return [(1, (bounds[1] // s + 2 * GATHER_HALO) * (SPATIAL_W // s), c, dtype, share)
            for s, c, dtype in ((4, 9, torch.float32), (4, 184, torch.bfloat16), (2, 40, torch.bfloat16))]


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


def _library_linear(torch, vol, pos, g):
    """(forward, backward) closures of the one PyTorch call that computes
    the single-level lerp with zeros outside [0, L): `grid_sample`
    (bilinear, zero padding, align_corners=True) on the volume viewed as
    [R, 1, 1, L], and its backward in the volume alone
    (`grid_sampler_2d_backward`, output_mask [True, False]), for positions
    pos [R, K] and the cotangent g [R, K].  The grid is made outside the
    timing."""
    import torch.nn.functional as F

    rows, length = vol.shape
    x = pos * (2.0 / (length - 1)) - 1.0  # align_corners=True; y = 0, the one row
    grid = torch.stack([x, torch.zeros_like(x)], -1)[:, None]  # [R, 1, K, 2]
    vol4, g4 = vol.reshape(rows, 1, 1, length), g.reshape(rows, 1, 1, -1)

    def fwd():
        return F.grid_sample(vol4, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True).reshape(rows, -1)

    def bwd():
        return torch.ops.aten.grid_sampler_2d_backward(g4, vol4, grid, 0, 0, True,
                                                       [True, False])[0].reshape(rows, length)

    return fwd, bwd


def _library_atol(length):
    """Tolerance of `grid_sample` against the kernels on unit-normal volumes.
    Its trip through normalised coordinates, x = 2p/(L-1) - 1 and back,
    rounds a position by a few units of L*2^-24, and a lerp moves by that
    times the step between two entries (up to ~7 on unit normals): 1e-3 up
    to L = 312, growing with L beyond."""
    return LIBRARY_ATOL * max(1.0, length / 312)


def _check_library(torch, res, what, vol, pos, g, got, dgot):
    """`grid_sample` and its backward against the kernels' outputs `got`
    and `dgot` (on these unit-normal inputs), within `_library_atol`."""
    fwd, bwd = _library_linear(torch, vol, pos, g)
    tol = _library_atol(vol.shape[1])
    res["library_err"] = float((fwd() - got).abs().max())
    res["library_bwd_err"] = float((bwd() - dgot).abs().max())
    if not (res["library_err"] <= tol and res["library_bwd_err"] <= tol):
        raise AssertionError(f"{what} {res['call']}: grid_sample and its backward differ from the "
                             f"kernels by {res['library_err']}, {res['library_bwd_err']} (tolerance {tol})")


def _kernels_linear(torch):
    """The single-level linear lookups, forward and backward, fp32.  Kernel
    and plain version do the same operations in the same order (explicit
    round-to-nearest intrinsics, no FMA; the rows backward adds a row's taps
    in ascending k, no atomics), so they must agree exactly; far positions
    (+-1e6, +-3e9) must give zero taps and written zero gradients.  The
    library column is `grid_sample` and its backward (`_library_linear`),
    held to the kernels within `_library_atol`."""
    from anystereo_tpu_torch.ops.kernels import lookup_linear as tl

    src, jax_file = "anystereo_tpu_torch/csrc/lookup_linear.cu", "anystereo_tpu/ops/pallas/lookup_kernel.py"
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    far = torch.tensor([-3e9, 3e9, -1e6, 1e6], device=DEVICE)
    radius = (TAPS - 1) // 2

    def timed(res, what, fn, plain, nbytes, flops, library, gather_body=None):
        res.update(max_abs_err=0.0, bytes=nbytes, flops=flops)
        res["ms"] = _time_ms(torch, fn)
        res["plain_ms"] = _time_ms(torch, plain, reps=5)
        res["library_ms"] = _time_ms(torch, library)
        if gather_body is not None:
            res["gather_body_ms"] = _time_ms(torch, gather_body)
        res["bound_ms"], res["bound_by"] = _bound(nbytes, flops)
        body = "" if gather_body is None else f", torch.gather body {res['gather_body_ms']:.4f} ms"
        _log(f"[kernels] {what} {res['call']} R={res['rows']} L={res['length']} K={res['taps']}: "
             f"exact; kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, grid_sample "
             f"{'backward ' if what.endswith('_bwd') else ''}{res['library_ms']:.4f} ms (max |diff| "
             f"{res['library_err']:.3g}, {res['library_bwd_err']:.3g} backward){body}, bound "
             f"{res['bound_ms']:.4f} ms ({nbytes} B)")
        return res

    # the window form at the eight eval level shapes and the four training ones
    win_fwd, win_bwd = [], []
    for call, rows, length in _level_shapes():
        vol = torch.randn(rows, length, device=DEVICE, generator=gen)
        base_main = torch.rand(rows, device=DEVICE, generator=gen) * length - radius
        base = torch.rand(rows, device=DEVICE, generator=gen) * (length + 40) - 20 - radius
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
        steps = torch.arange(TAPS, device=DEVICE)
        res_f, res_b = dict(shape), dict(shape)
        _check_library(torch, res_f, "gather_window_linear", vol[4:], base[4:, None] + steps, cot[4:],
                       got[4:], dgot[4:])  # the far starts left out
        res_b.update(library_err=res_f["library_err"], library_bwd_err=res_f["library_bwd_err"])
        lib_fwd, lib_bwd = _library_linear(torch, vol, base_main[:, None] + steps, cot)
        i0 = torch.floor(base_main).long()
        live = (i0 + TAPS + 1).clamp(0, length) - i0.clamp(0, length)  # entries inside the window
        win_fwd.append(timed(
            res_f, "gather_window_linear", lambda: tl.gather_window_linear(vol, base_main, TAPS),
            lambda: tl.gather_window_linear_ref(vol, base_main, TAPS),
            4 * int(live.sum()) + 4 * rows + 4 * rows * TAPS, 4 * rows * TAPS, lib_fwd))
        # B7, the "levels" flavor's lookup: level i of the smooth field of
        # `_path_positions`, x / 2^i - radius
        volume, level = call.rsplit("_l", 1)
        base_path = (_path_positions(torch, volume, rows) * 2.0 ** -int(level) - radius).contiguous()
        i0 = torch.floor(base_path).long()
        live = (i0 + TAPS + 1).clamp(0, length) - i0.clamp(0, length)
        _kernel_beside(torch, res_f, "gather_window_linear",
                       lambda: tl.gather_window_linear(vol, base_main, TAPS),
                       lambda: tl.gather_window_linear(vol, base, TAPS),
                       lambda: tl.gather_window_linear(vol[:1], base_main[:1], TAPS),
                       path=(lambda: tl.gather_window_linear(vol, base_path, TAPS),
                             lambda: tl.gather_window_linear_ref(vol, base_path, TAPS),
                             4 * int(live.sum()) + 4 * rows + 4 * rows * TAPS))
        win_bwd.append(timed(
            res_b, "gather_window_linear_bwd",
            lambda: tl.gather_window_linear_bwd(base_main, cot, length, TAPS),
            lambda: tl.gather_window_linear_bwd_ref(base_main, cot, length, TAPS),
            4 * rows * (1 + TAPS + length), 4 * rows * (TAPS + 1), lib_bwd))
        _kernel_beside(torch, res_b, "gather_window_linear_bwd",
                       lambda: tl.gather_window_linear_bwd(base_main, cot, length, TAPS),
                       lambda: tl.gather_window_linear_bwd(base, cot, length, TAPS),
                       lambda: tl.gather_window_linear_bwd(base_main[:1], cot[:1], length, TAPS))
        del vol, cot, lib_fwd, lib_bwd

    # arbitrary positions: the evaluator's occlusion warp (KITTI-sized frames,
    # and SceneFlow's in the trainer's validation), and the small op shape
    rows_fwd, rows_bwd = [], []
    for call, rows, length, taps in (("occ_mask", EVAL_H, EVAL_W, EVAL_W), ("op_300x312x9", 300, 312, 9),
                                     ("sf_occ_mask", SF_H, SF_W, SF_W)):
        vol = torch.rand(rows, length, device=DEVICE, generator=gen) * 60
        if call.endswith("occ_mask"):  # x - disparity, as `warp_disparity` forms it
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
        res_f, res_b = dict(shape), dict(shape)
        unit = torch.randn(rows, length, device=DEVICE, generator=gen)  # the library check's volume
        _check_library(torch, res_f, "gather_rows_linear", unit, pos_main, cot,
                       tl.gather_rows_linear(unit, pos_main), tl.gather_rows_linear_bwd(pos_main, cot, length))
        res_b.update(library_err=res_f["library_err"], library_bwd_err=res_f["library_bwd_err"])
        lib_fwd, lib_bwd = _library_linear(torch, vol, pos_main, cot)
        i0 = torch.floor(pos_main).clamp(-2, length).long()
        touched = torch.zeros(rows, length + 4, dtype=torch.bool, device=DEVICE)
        touched.scatter_(1, i0 + 2, True)
        touched.scatter_(1, i0 + 3, True)
        vol_bytes = 4 * int(touched[:, 2:length + 2].sum())  # each entry some tap reads, once
        rows_fwd.append(timed(
            res_f, "gather_rows_linear", lambda: tl.gather_rows_linear(vol, pos_main),
            lambda: tl.gather_rows_linear_ref(vol, pos_main), vol_bytes + 8 * rows * taps,
            4 * rows * taps, lib_fwd, gather_body=lambda: _old_gather_1d_linear(torch, vol, pos_main)))
        _kernel_beside(torch, res_f, "gather_rows_linear", lambda: tl.gather_rows_linear(vol, pos_main),
                       lambda: tl.gather_rows_linear(vol, pos),
                       lambda: tl.gather_rows_linear(vol[:1], pos_main[:1]))
        rows_bwd.append(timed(
            res_b, "gather_rows_linear_bwd", lambda: tl.gather_rows_linear_bwd(pos_main, cot, length),
            lambda: tl.gather_rows_linear_bwd_ref(pos_main, cot, length),
            4 * rows * (2 * taps + length), 5 * rows * taps, lib_bwd))
        _kernel_beside(torch, res_b, "gather_rows_linear_bwd",
                       lambda: tl.gather_rows_linear_bwd(pos_main, cot, length),
                       lambda: tl.gather_rows_linear_bwd(pos, cot, length),
                       lambda: tl.gather_rows_linear_bwd(pos_main[:1], cot[:1], length))
        del vol, cot, unit, lib_fwd, lib_bwd
    # one IGEV iteration's four launches: the forward's at the eval shapes, the
    # backward's at the training shapes (the one path that runs it)
    calls = [c["call"] for c in win_fwd]
    eval_iteration = tuple(calls.index(f"{v}_l{i}") for v in ("gev", "corr") for i in range(IGEV_LEVELS))
    train_iteration = tuple(calls.index(f"train_{v}_l{i}") for v in ("gev", "corr")
                            for i in range(IGEV_LEVELS))
    return [
        _record("gather_window_linear", src, f"{jax_file}:215", win_fwd, main=eval_iteration,
                paths=("eval_levels", "train_levels"), library=True),
        _record("gather_window_linear_bwd", src, f"{jax_file}:155", win_bwd, main=train_iteration,
                paths=("train_levels",), library=True),
        _record("gather_rows_linear", src, f"{jax_file}:1137", rows_fwd, main=(0,),
                paths=("validate", "trainer", "cli"), library=True),
        _record("gather_rows_linear_bwd", src, f"{jax_file}:63", rows_bwd, main=(0,), paths=("op",),
                library=True),
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
    _yardstick(torch)
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


def _positive(x):
    return isinstance(x, (int, float)) and 0 < x < float("inf")


def phase_bench(torch, kernels, card):
    """`python -m anystereo_tpu_torch.cli bench` as a user runs it, here
    `cli.main(["bench"])` in this process with its standard output
    captured, so that the counts see its launches (set to 0 just before,
    read just after): B1 64 a forward, nothing else.  Its line must hold
    every key, finite positive pairs/s and latencies, and the card's name;
    the run must exit 0 (the bench raises when its chained output leaves
    the band of its direct one).  Then the FLOP count of one forward at the
    protocol (`flops_estimate`, its launches not counted), beside
    `latency_ms` as TFLOP/s and a share of the bf16 peak.  Returns the
    launches."""
    import io

    from anystereo_tpu_torch import bench, cli
    from anystereo_tpu_torch.config import ModelConfig
    from anystereo_tpu_torch.nn.model import build_model
    from anystereo_tpu_torch.utils.profiling import H100_PEAK, flops_estimate

    # bench.run: 1 direct, N_REP synchronised, then the harness's chains of 1
    # and K, each once to warm up and REPS times timed
    forwards = 1 + bench.N_REP + (1 + bench.K) * (1 + bench.REPS)
    want = dict.fromkeys((k.__name__ for k in kernels), 0)
    want.update(_lookup_counts("igev", "aligned", bench.ITERS * forwards))
    buf = io.StringIO()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench"])
    seconds = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    text = buf.getvalue()
    _log(text.rstrip())
    if rc != 0:
        raise AssertionError(f"cli.main(['bench']) exited {rc}: {text[-3000:]}")
    _expect_launches(kernels, [0] * len(kernels), want, f"the bench ({forwards} forwards)")
    found = [row for row in text.splitlines() if row.startswith("{")]
    if len(found) != 1:
        raise AssertionError(f"the bench printed {len(found)} JSON lines: {text[-3000:]}")
    line = json.loads(found[0])
    missing = [key for key in bench.LINE_KEYS if key not in line]
    bad = [key for key in ("value", "latency_ms", "latency_ms_e2e") if not _positive(line.get(key))]
    if missing or bad or line["device"] != card:
        raise AssertionError(f"the bench line lacks {missing}, has {bad} not finite and positive, or names "
                             f"{line.get('device')!r} for {card!r}: {found[0]}")

    model = build_model(ModelConfig(), device=DEVICE, seed=0)
    left, right = (torch.rand(bench.B, bench.H, bench.W, 3, device=DEVICE) * 255 for _ in range(2))
    flops = flops_estimate(lambda l, r: model(l, r, iters=bench.ITERS).disp_final, left, right)
    del model
    pair_ms = PAIR_MS[("igev", "aligned")]
    rate = flops / (line["latency_ms"] / 1e3)
    _keep("bench", f"[bench] cli.main(['bench']) exit 0 in {seconds:.1f} s, {forwards} forwards, launches "
                   f"{ {k: v for k, v in launches.items() if v} }; {json.dumps(line)}; latency_ms "
                   f"{line['latency_ms']} and latency_ms_e2e {line['latency_ms_e2e']} beside the model phase's "
                   f"{pair_ms:.2f} ms a pair (ratios {line['latency_ms'] / pair_ms:.3f}, "
                   f"{line['latency_ms_e2e'] / pair_ms:.3f}); flops_estimate of one forward "
                   f"{flops / 1e12:.4f} TFLOP ({flops:.0f}); {rate / 1e12:.2f} TFLOP/s at latency_ms, "
                   f"{100 * rate / H100_PEAK['bf16_flops']:.2f}% of the bf16 peak "
                   f"({H100_PEAK['bf16_flops'] / 1e12:.0f} TFLOP/s at 700 W); {card}")
    return launches


# ----------------------------------------------------------------- phase 5


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


# ----------------------------------------------------------------- phase 6


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


def _step_counts(kernels, core, flavor, it, remat=False):
    """Expected launches of one training step of `it` iterations: per
    iteration one lookup forward and one backward a volume, and per decode
    the three query tables through the gather forward and the scatter-add
    backward.  Under `remat` the backward runs each iteration's body again
    (`nn/model.py`: the GRU update and the query decode under
    `torch.utils.checkpoint`), so the lookup forwards and the gathers launch
    twice; the backward kernels launch as often as without."""
    runs = 2 if remat else 1
    want = dict.fromkeys((k.__name__ for k in kernels), 0)
    want.update({name: runs * n for name, n in _lookup_counts(core, flavor, it).items()})
    want.update({name + "_bwd": n for name, n in _lookup_counts(core, flavor, it).items()})
    want.update(gather_rows=runs * 3 * it, scatter_rows_add=3 * it)
    return want


def _expect_launches(kernels, before, want, what):
    got = {k.__name__: k.launches - b for k, b in zip(kernels, before)}
    if got != want:
        raise AssertionError(f"kernel launches of {what}: {got}, want {want}")


def phase_train(torch, kernels, core, flavor, steps=TRAIN_STEPS, remat=False):
    """One warm-up and `steps` timed training steps of one model under
    one lookup flavor at full width (with `remat`, `ModelConfig(remat=True)`),
    with the exact launch counts of each (`_step_counts`)."""
    from anystereo_tpu_torch.config import TrainConfig
    from anystereo_tpu_torch.nn.model import build_model
    from anystereo_tpu_torch.train.state import create_train_state
    from anystereo_tpu_torch.train.step import make_train_step

    tcfg = TrainConfig()
    model = build_model(_config(core, remat=remat), device=DEVICE, seed=0)
    state = create_train_state(model, tcfg)
    step = make_train_step(model, tcfg)
    batch = _train_batch(torch, tcfg.batch_size, TRAIN_H, TRAIN_W, tcfg.sample_q, seed=4)
    it = tcfg.train_iters
    per_step = _step_counts(kernels, core, flavor, it, remat)
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
            _expect_launches(kernels, before, per_step, f"{core} training step {i} ({flavor}"
                             f"{', remat' if remat else ''})")
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
    STEP_MS[(core, flavor, remat)] = (sum(times) / len(times), peak)
    _log(f"[train] {core.upper()} training step {tcfg.batch_size}x{TRAIN_H}x{TRAIN_W}, Q "
         f"{tcfg.sample_q}, {it} iters, bf16, lookup {flavor}{', remat' if remat else ''}: "
         f"{sum(times) / len(times):.2f} "
         f"ms/step over {steps} steps ({', '.join(f'{t:.2f}' for t in times)} ms; warm-up "
         f"excluded), peak {peak:.2f} GiB; losses {[round(v, 4) for v in losses]}; last grad_norm "
         f"{gnorm:.3f}, lr {metrics['lr']:.3e}, epe {float(metrics['epe']):.3f} px; launches per "
         f"step {({k: v for k, v in per_step.items() if v})}; parameters with an exactly zero "
         f"gradient: {zero}")
    return launches, (model, tcfg, state, step, batch)


# ----------------------------------------------------------------- phase 7


SF_H, SF_W, SF_TRAIN, SF_TEST = 540, 960, 8, 2  # SceneFlow's frame size; pairs of the tree
KITTI_FRAMES = 2
FT_NAMES = ("kitchen_0/000000", "kitchen_0/000001", "temple_4/000000")  # FallingThings frames
FT_FX = 768.1605  # FallingThings' left camera, _camera_settings.json
JPEG_FIXTURES = os.path.join("tests", "data", "jpeg")  # committed JPEGs and PIL's digests of them
FORMAT_FIXTURES = os.path.join("tests", "data", "formats")  # every PNG, JPEG and PPM form, PIL's digests
FT_PROGRESSIVE = "temple_4/000000"  # the FallingThings frame whose left view is the progressive JPEG
READER_REPS = 5
AUG_SCALE = (1.31, 1.17)  # a stretched scale the dense augmentor draws
SPARSE_SCALE = 2 ** 0.3  # one the sparse augmentor draws (no stretch)
TRAINER_STEPS, TRAINER_RESUMED, TRAINER_CKPT_EVERY, TRAINER_VAL_FRAMES = 4, 6, 2, 2
TRAINER_WORKERS = 4
LOADER_BATCHES = 8  # batches the loader makes alone, timed
LOADER_SERIAL = 4  # samples made one at a time on one thread, timed
EPE_ATOL = 1e-3  # px, run_validation from the checkpoint against the in-training validation


def _stereo_pair(np, rng, h, w, dmin, dmax):
    """A blurred-noise texture and a smooth disparity field in [dmin, dmax];
    the right view is the texture resampled at x + d (so left(x) matches
    right(x - d))."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    margin = int(dmax) + 2
    tex = gaussian_filter(rng.rand(h, w + margin, 3).astype(np.float32), (1.2, 1.2, 0))
    tex = (tex - tex.min()) / (tex.max() - tex.min()) * 255
    field = gaussian_filter(rng.rand(h // 8, w // 8).astype(np.float32), 3)
    field = (field - field.min()) / max(float(np.ptp(field)), 1e-6)
    disp = np.kron(field, np.ones((8, 8), np.float32))
    disp = np.pad(disp, ((0, h - disp.shape[0]), (0, w - disp.shape[1])), mode="edge")
    disp = dmin + (dmax - dmin) * gaussian_filter(disp, 4)
    left = tex[:, :w]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    right = np.stack([map_coordinates(tex[..., c], [ys, xs + disp], order=1) for c in range(3)], -1)
    return left.astype(np.uint8), np.clip(right, 0, 255).astype(np.uint8), disp.astype(np.float32)


def _write_trees(np, root):
    """A SceneFlow tree (frames_finalpass and disparity, left and right views,
    SF_TRAIN + SF_TEST pairs at 540x960), a KITTI 2015 tree of
    KITTI_FRAMES frames at 375x1242 with 16-bit disp_occ_0 / disp_noc_0,
    written by the port's own writers, and a FallingThings tree (`_write_ft`)."""
    from anystereo_tpu_torch.data.frame_utils import write_pfm
    from anystereo_tpu_torch.data.png import write_png

    rng = np.random.RandomState(1234)
    sf = os.path.join(root, "sceneflow")
    for split, n in (("TRAIN", SF_TRAIN), ("TEST", SF_TEST)):
        for i in range(n):
            left, right, disp = _stereo_pair(np, rng, SF_H, SF_W, 8.0, 60.0)
            for view, img in (("left", left), ("right", right)):
                d = os.path.join(sf, "frames_finalpass", split, "A", "0000", view)
                os.makedirs(d, exist_ok=True)
                write_png(os.path.join(d, f"{i:04d}.png"), img)
                d = os.path.join(sf, "disparity", split, "A", "0000", view)
                os.makedirs(d, exist_ok=True)
                write_pfm(os.path.join(d, f"{i:04d}.pfm"), disp)
    kitti = os.path.join(root, "kitti15")
    for i in range(KITTI_FRAMES):
        left, right, disp = _stereo_pair(np, rng, EVAL_H, EVAL_W, 5.0, 80.0)
        occ = np.where(rng.rand(EVAL_H, EVAL_W) < 0.3, 0, np.round(disp * 256)).astype(np.uint16)
        noc = occ.copy()
        noc[:, : EVAL_W // 8] = 0  # a band only the occluded ground truth covers
        for sub, img in (("image_2", left), ("image_3", right), ("disp_occ_0", occ), ("disp_noc_0", noc)):
            d = os.path.join(kitti, "training", sub)
            os.makedirs(d, exist_ok=True)
            write_png(os.path.join(d, f"{i:06d}_10.png"), img)
    return sf, kitti, _write_ft(np, root)


def _write_ft(np, root):
    """A FallingThings tree: `filenames.txt`, each frame's left and right
    views a copy of the committed 540x960 JPEG pair (`JPEG_FIXTURES`, made
    by `_stereo_pair` at the seed in its `digests.json`), except the left
    view of FT_PROGRESSIVE, the committed progressive JPEG of the same view
    (`FORMAT_FIXTURES`, same seed, PIL quality 75), its 16-bit
    `*.left.depth.png` the pair's disparity turned into FallingThings' depth
    (fx * 600 / d, written by `write_png`), and `_camera_settings.json`
    beside them."""
    import shutil

    from anystereo_tpu_torch.data.png import write_png

    with open(os.path.join(JPEG_FIXTURES, "digests.json")) as f:
        record = json.load(f)
    pair, (h, w, _) = record["stereo"], record["files"]["stereo.left.jpg"]["shape"]
    with open(os.path.join(FORMAT_FIXTURES, "digests.json")) as f:
        progressive = json.load(f)["stereo"]
    if any(progressive[k] != pair[k] for k in ("seed", "dmin", "dmax")):
        raise AssertionError(f"the progressive fixture's view {progressive} is not the JPEG pair's {pair}")
    _, _, disp = _stereo_pair(np, np.random.RandomState(pair["seed"]), h, w, pair["dmin"], pair["dmax"])
    depth = np.round(FT_FX * 6.0 * 100 / disp).astype(np.uint16)
    ft = os.path.join(root, "falling_things")
    for name in FT_NAMES:
        d = os.path.join(ft, os.path.dirname(name))
        os.makedirs(d, exist_ok=True)
        for view in ("left", "right"):
            src = os.path.join(JPEG_FIXTURES, f"stereo.{view}.jpg")
            if name == FT_PROGRESSIVE and view == "left":
                src = os.path.join(FORMAT_FIXTURES, progressive["file"])
            shutil.copy(src, os.path.join(ft, f"{name}.{view}.jpg"))
        write_png(os.path.join(ft, f"{name}.left.depth.png"), depth)
        with open(os.path.join(d, "_camera_settings.json"), "w") as f:
            json.dump({"camera_settings": [{"intrinsic_settings": {"fx": FT_FX}}]}, f)
    with open(os.path.join(ft, "filenames.txt"), "w") as f:
        f.write("".join(f"{name}.left.jpg\n" for name in FT_NAMES))
    return ft


def _ms(fn, reps=READER_REPS):
    """Best and median host ms of `fn()` over `reps` calls, after one call
    (the first builds the C library); and the last result."""
    out = fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[0], times[len(times) // 2], out


def _write_adam7(np, path, img):
    """`img` ([H, W, 3] uint8) as an Adam7-interlaced PNG: seven sub-images
    (the reader's `_ADAM7`: first column, first row, steps), each with its
    own rows of filter bytes, every row Paeth-filtered."""
    import struct
    import zlib

    from anystereo_tpu_torch.data.png import _ADAM7, _filter

    def chunk(kind, body):
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)

    h, w, c = img.shape
    stream = []
    for x0, y0, dx, dy in _ADAM7:
        sub = np.ascontiguousarray(img[y0::dy, x0::dx])
        if sub.size:
            rows = _filter(sub.reshape(sub.shape[0], -1), c, 4)
            stream.append(np.concatenate([np.full((rows.shape[0], 1), 4, np.uint8), rows], axis=1).tobytes())
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1)) +
                chunk(b"IDAT", zlib.compress(b"".join(stream))) + chunk(b"IEND", b""))


def _digests_hold(np, folder, read, record="digests.json"):
    """Raise unless `read` gives every file named in `folder`'s `record`
    its recorded digest (shape, dtype where recorded, sha256 of the bytes):
    PIL's decode in digests.json, OpenCV's KITTI disparity in
    opencv_digests.json; the count."""
    import hashlib

    with open(os.path.join(folder, record)) as f:
        files = json.load(f)["files"]
    for name, want in files.items():
        got = np.asarray(read(os.path.join(folder, name)))
        have = {"shape": list(got.shape), "dtype": str(got.dtype),
                "sha256": hashlib.sha256(got.tobytes()).hexdigest()}
        if any(have[k] != want[k] for k in want):
            raise AssertionError(f"the port's decode of {folder}/{name} is not the one {record} records: "
                                 f"{have} against {want}")
    return len(files)


def _new_forms_part(np, root):
    """The C decode of the JPEG forms the readers took on last, at the
    committed pair's 540x960, beside the Huffman files of that size: the
    committed progressive view cut after its first and third scans
    (smoothed; the DC interpolated while no AC scan has come), sequential
    and progressive arithmetic-coded 4:2:0 files (SOF9, SOF10; restarts
    every MCU row) of seeded coefficients, and a lossless file (SOF3,
    predictor 7, restarts every 8 rows) of a 540x960 gray view, all written
    by `tests/jpeg_writers.py` here (PIL, the reference for their bytes in
    the tests, is not on this host).  Returns the line's part."""
    import importlib.util

    from anystereo_tpu_torch.data.jpeg import decode_jpeg, read_jpeg

    spec = importlib.util.spec_from_file_location("jpeg_writers", os.path.join("tests", "jpeg_writers.py"))
    writers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(writers)
    prog = open(os.path.join(FORMAT_FIXTURES, "stereo.left.progressive.jpg"), "rb").read()
    scans = [i for i in range(len(prog) - 1) if prog[i] == 0xFF and prog[i + 1] == 0xDA]
    rng = np.random.RandomState(23)
    sampling = [(2, 2), (1, 1), (1, 1)]
    blocks = [writers.random_blocks(rng, 68, 120, 0.5), writers.random_blocks(rng, 34, 60, 0.5),
              writers.random_blocks(rng, 34, 60, 0.5)]
    gray = read_jpeg(os.path.join(JPEG_FIXTURES, "stereo.left.jpg"))[..., 1]
    files = {"progressive cut after scan 1 (DC only, smoothed)": prog[:scans[1]] + b"\xff\xd9",
             "progressive cut after scan 3 (smoothed)": prog[:scans[3]] + b"\xff\xd9",
             "arithmetic sequential (SOF9)": writers.arith_jpeg(540, 960, sampling, blocks, restart=60),
             "arithmetic progressive (SOF10)": writers.arith_jpeg(540, 960, sampling, blocks, progressive=True,
                                                                  restart=60, script=writers.PROGRESSION),
             "lossless gray (SOF3)": writers.lossless_jpeg([gray], [(1, 1)], 7, 0, restart=960 * 8)}
    parts = []
    for form, data in files.items():
        best, med, out = _ms(lambda: decode_jpeg(data, form))
        if out.shape[:2] != (540, 960) or (form.startswith("lossless") and not np.array_equal(out, gray)):
            raise AssertionError(f"the {form} file decodes to {out.shape}, not the 540x960 it was written as")
        parts.append(f"{form} ({len(data)} bytes): C {best:.2f} (median {med:.2f})")
    return "; ".join(parts)


def _readers_line(np, root, sf, kitti, card):
    """A line of the readers' times on the card's host, the C decode beside
    the plain version (`read_png(..., impl="numpy")`) on the same files: a
    SceneFlow frame and a KITTI 16-bit disparity as the tree's writer
    filters them (None) and with every row Paeth-filtered, the SceneFlow
    frame Adam7-interlaced (`_write_adam7`), the committed 540x960
    baseline and progressive JPEGs of one view and the forms of
    `_new_forms_part` (no plain version: their reference is PIL, whose
    digests of every committed JPEG and of every file of `FORMAT_FIXTURES`
    the C decodes must give, and OpenCV, whose KITTI disparity of every
    file of `FORMAT_FIXTURES` it reads `read_disp_kitti` must give); the
    host compiler's version."""
    from anystereo_tpu_torch.data import frame_utils
    from anystereo_tpu_torch.data.jpeg import read_jpeg
    from anystereo_tpu_torch.data.png import read_png, write_png
    from anystereo_tpu_torch.ops.kernels import build

    n_jpeg = _digests_hold(np, JPEG_FIXTURES, read_jpeg)
    n_formats = _digests_hold(np, FORMAT_FIXTURES, frame_utils.read_gen)
    n_opencv = _digests_hold(np, FORMAT_FIXTURES, lambda p: frame_utils.read_disp_kitti(p)[0],
                             "opencv_digests.json")
    frames = {f"{SF_H}x{SF_W} RGB": os.path.join(sf, "frames_finalpass", "TRAIN", "A", "0000", "left",
                                                  "0000.png"),
              f"{EVAL_H}x{EVAL_W} 16-bit": os.path.join(kitti, "training", "disp_occ_0", "000000_10.png")}
    parts = []
    for kind, path in frames.items():
        img = read_png(path, impl="numpy")
        paeth = os.path.join(root, "paeth.png")
        write_png(paeth, img, filter_type=4)
        for filt, p in (("None", path), ("Paeth", paeth)):
            c_best, c_med, got = _ms(lambda: read_png(p))
            n_best, n_med, plain = _ms(lambda: read_png(p, impl="numpy"))
            if not (np.array_equal(got, img) and np.array_equal(plain, img)):
                raise AssertionError(f"read_png of the {filt}-filtered {kind} file: the C decode and "
                                     f"the plain one disagree")
            parts.append(f"{kind} {filt}: C {c_best:.2f} (median {c_med:.2f}), numpy {n_best:.2f} "
                         f"(median {n_med:.2f})")
        if kind.endswith("RGB"):
            adam7 = os.path.join(root, "adam7.png")
            _write_adam7(np, adam7, img)
            c_best, c_med, got = _ms(lambda: read_png(adam7))
            n_best, n_med, plain = _ms(lambda: read_png(adam7, impl="numpy"))
            if not (np.array_equal(got, img) and np.array_equal(plain, img)):
                raise AssertionError(f"read_png of the Adam7 {kind} file: the C decode and the plain one "
                                     f"are not the frame")
            parts.append(f"{kind} Adam7 Paeth: C {c_best:.2f} (median {c_med:.2f}), numpy {n_best:.2f} "
                         f"(median {n_med:.2f})")
    for name, form in (("stereo.left.jpg", "baseline"), ("stereo.left.progressive.jpg", "progressive")):
        jpg = os.path.join(JPEG_FIXTURES if form == "baseline" else FORMAT_FIXTURES, name)
        j_best, j_med, decoded = _ms(lambda: read_jpeg(jpg))
        parts.append(f"{decoded.shape[0]}x{decoded.shape[1]} {form} JPEG ({os.path.getsize(jpg)} bytes, PIL "
                     f"quality 75, 4:2:0): C {j_best:.2f} (median {j_med:.2f})")
    parts.append(_new_forms_part(np, root))
    cc = build._cc(build.CSRC / "jpeg_decode.c")
    version = subprocess.run([cc, "--version"], capture_output=True, text=True,
                             timeout=60).stdout.splitlines()[0]
    return (f"[trainer] readers ms (best of {READER_REPS}, on the card's host): " + "; ".join(parts) +
            f"; {n_jpeg} committed JPEGs and all {n_formats} files of {FORMAT_FIXTURES} (PNG, JPEG and PPM "
            f"of every form) decode to PIL's digests, and {n_opencv} of them (every one OpenCV reads) to "
            f"OpenCV's KITTI disparity (EXIF orientation, gamma gray, JPEG and Netpbm maps); compiler {cc}: "
            f"{version}; {card}")


def _identical(got, want, what):
    """Raise unless the arrays (or tuples, or dicts of them) have the same
    dtypes, shapes and bytes."""
    import numpy as np

    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{what}: keys {sorted(got)} against {sorted(want)}")
        got, want = [got[k] for k in sorted(want)], [want[k] for k in sorted(want)]
    pairs = zip(got, want) if isinstance(want, (tuple, list)) else [(got, want)]
    for i, (g, w) in enumerate(pairs):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype != w.dtype or g.shape != w.shape or g.tobytes() != w.tobytes():
            raise AssertionError(f"{what} [{i}]: the C path's {g.dtype} {g.shape} is not the plain "
                                 f"version's {w.dtype} {w.shape} bit for bit")


def _augment_line(np, root, sf, kitti, ds, card):
    """A line of the augmentor's host C on the card's host: each function at
    the path's shapes, held to its plain numpy version bit for bit, both
    timed (best and median of READER_REPS); then one SceneFlow sample of the
    trainer's dataset `ds` and one KITTI sample (sparse, 320x736 crops, the
    spatial step always taken so the sparse rescale runs) through
    `StereoDataset.__getitem__` on the C path and on the plain path
    (`host_c.plain()`) from one seed, every array identical, with the C
    functions each C sample called."""
    from anystereo_tpu_torch.config import TrainConfig
    from anystereo_tpu_torch.data import augment, frame_utils, native_io
    from anystereo_tpu_torch.data.augment import AugmentorConfig
    from anystereo_tpu_torch.data.datasets import KittiDataset
    from anystereo_tpu_torch.data.png import read_png
    from anystereo_tpu_torch.utils import host_c
    from anystereo_tpu_torch.utils.resize import resize

    frames = [os.path.join(sf, "frames_finalpass", "TRAIN", "A", "0000", view, "0000.png")
              for view in ("left", "right")]
    left, right = (read_png(p) for p in frames)
    pfm = os.path.join(sf, "disparity", "TRAIN", "A", "0000", "left", "0000.pfm")
    flow = np.stack([frame_utils.read_pfm(pfm, impl="numpy"), np.zeros((SF_H, SF_W), np.float32)], -1)
    stack = np.concatenate([left, right], axis=0)
    hsv = augment.rgb_to_hsv(stack, impl="numpy")
    kdisp, kvalid = frame_utils.read_disp_kitti(os.path.join(kitti, "training", "disp_occ_0",
                                                             "000000_10.png"))
    kflow = np.stack([kdisp, np.zeros_like(kdisp)], -1).astype(np.float32)
    sparse = augment.StereoAugmentor(AugmentorConfig(), sparse=True)
    crop = left[:400, :800]
    cases = {
        f"bilinear u8 {SF_H}x{SF_W}x3 by {AUG_SCALE}": lambda i: resize(left, None, "linear", scale=AUG_SCALE,
                                                                      impl=i),
        f"bilinear f32 {SF_H}x{SF_W}x2 flow by {AUG_SCALE}": lambda i: resize(flow, None, "linear",
                                                                             scale=AUG_SCALE, impl=i),
        "bicubic u8 400x800x3 -> 160x320x3": lambda i: resize(crop, (320, 160), "cubic", impl=i),
        f"gray {2 * SF_H}x{SF_W}x3": lambda i: augment.rgb_to_gray(stack, impl=i),
        f"RGB->HSV {2 * SF_H}x{SF_W}x3": lambda i: augment.rgb_to_hsv(stack, impl=i),
        f"HSV->RGB {2 * SF_H}x{SF_W}x3": lambda i: augment.hsv_to_rgb(hsv, impl=i),
        f"read_pfm {SF_H}x{SF_W}": lambda i: frame_utils.read_pfm(pfm, impl=i),
        f"sparse rescale {EVAL_H}x{EVAL_W} ({int(kvalid.sum())} valid) by {SPARSE_SCALE:.4f}":
            lambda i: sparse._resize_sparse_flow(kflow, kvalid, SPARSE_SCALE, SPARSE_SCALE, impl=i),
    }
    parts = []
    for what, fn in cases.items():
        c_best, c_med, got = _ms(lambda: fn("c"))
        n_best, n_med, want = _ms(lambda: fn("numpy"))
        _identical(got, want, what)
        parts.append(f"{what}: C {c_best:.2f} (median {c_med:.2f}), numpy {n_best:.2f} (median {n_med:.2f})")
    if not native_io.available():
        raise AssertionError("native_io: the C library did not build")
    kitti_ds = KittiDataset(kitti, AugmentorConfig(crop_size=TrainConfig().crop_size, spatial_aug_prob=1.0))
    calls = {}
    own = host_c.function

    def counted(source, name, *a, **kw):
        calls[name] = calls.get(name, 0) + 1
        return own(source, name, *a, **kw)

    for name, dataset in (("SceneFlow multi-scale", ds), ("KITTI sparse", kitti_ds)):
        calls.clear()
        host_c.function = counted
        try:
            t0 = time.perf_counter()
            got = dataset.__getitem__(0, rng=np.random.RandomState(SF_TRAIN))
            c_ms = (time.perf_counter() - t0) * 1e3
        finally:
            host_c.function = own
        with host_c.plain():
            t0 = time.perf_counter()
            want = dataset.__getitem__(0, rng=np.random.RandomState(SF_TRAIN))
            n_ms = (time.perf_counter() - t0) * 1e3
        _identical(got, want, f"the {name} sample")
        need = {"resize_linear_u8", "rgb_to_gray", "rgb_to_hsv", "hsv_to_rgb"} | \
            ({"scatter_resize_sparse"} if "KITTI" in name else {"pfm_header"})
        if not need <= set(calls):
            raise AssertionError(f"the {name} sample on the C path called {calls}, not all of {sorted(need)}")
        parts.append(f"{name} sample C {c_ms:.1f} ms, plain {n_ms:.1f} ms, identical (C calls "
                     f"{dict(sorted(calls.items()))})")
    return (f"[trainer] augment ms (best of {READER_REPS}, on the card's host; C bit for bit its plain "
            f"numpy version): " + "; ".join(parts) + f"; {card}")


@contextlib.contextmanager
def _counted_reads():
    """Counts of the image decodes the readers make inside the block, by
    format (the loader's threads included)."""
    import threading

    from anystereo_tpu_torch.data import frame_utils

    counts = {"jpeg": 0, "png": 0, "progressive": 0}
    own = {"jpeg": frame_utils.read_jpeg, "png": frame_utils.read_png}
    lock = threading.Lock()

    def counted(kind):
        def read(path, *a, **kw):
            with lock:
                counts[kind] += 1
                counts["progressive"] += path.endswith(f"{FT_PROGRESSIVE}.left.jpg")
            return own[kind](path, *a, **kw)
        return read

    frame_utils.read_jpeg, frame_utils.read_png = counted("jpeg"), counted("png")
    try:
        yield counts
    finally:
        frame_utils.read_jpeg, frame_utils.read_png = own["jpeg"], own["png"]


def _igev_step_launches(kernels):
    """The launches of one IGEV training step at `TrainConfig()` ("aligned"):
    B1 32 + 32, gather 48, scatter 48, nothing else."""
    from anystereo_tpu_torch.config import TrainConfig

    it = TrainConfig().train_iters
    return {**dict.fromkeys((k.__name__ for k in kernels), 0), "gather_pyramid_aligned": 2 * it,
            "gather_pyramid_aligned_bwd": 2 * it, "gather_rows": 3 * it, "scatter_rows_add": 3 * it}


def _sceneflow_frame_launches(kernels):
    """The launches of one SceneFlow validation frame: B1 64 and B8 1 (the
    left-right occlusion warp)."""
    return {**dict.fromkeys((k.__name__ for k in kernels), 0), "gather_pyramid_aligned": 2 * ITERS,
            "gather_rows_linear": 1}


def phase_trainer(torch, kernels, card, root):
    """The training entry point from dataset files at full width: a SceneFlow
    tree on disk → `fetch_dataset` in multi-scale mode at `TrainConfig()`
    defaults → `PrefetchLoader` (batch 2, 4 workers, seed 1234) → `train()`
    for TRAINER_STEPS steps, a checkpoint and a SceneFlow validation of
    TRAINER_VAL_FRAMES frames every TRAINER_CKPT_EVERY steps; then a second
    `train()` on the same checkpoint directory that resumes at step
    TRAINER_STEPS and runs to TRAINER_RESUMED; then `run_validation` of the
    checkpoint on SceneFlow and on KITTI 2015.  The launches of every step
    and of every validation frame are checked exactly; the steps are timed
    (synchronised) by a wrapper around the trainer's step.  The trees stay
    in `root` for the phases after it; returns the launches and the trees'
    roots (SceneFlow, KITTI 2015, FallingThings)."""
    import numpy as np

    from anystereo_tpu_torch.config import Config, ModelConfig, TrainConfig
    from anystereo_tpu_torch.data.loader import PrefetchLoader, to_device
    from anystereo_tpu_torch.eval.validate import make_train_validate_fn, run_validation
    from anystereo_tpu_torch.nn.model import build_model
    from anystereo_tpu_torch.train import trainer
    from anystereo_tpu_torch.train.optimizer import one_cycle_schedule
    from anystereo_tpu_torch.train.state import (
        create_train_state,
        restore_checkpoint,
        save_checkpoint,
    )

    names = [k.__name__ for k in kernels]
    it = TrainConfig().train_iters
    per_step = _igev_step_launches(kernels)
    per_frame = _sceneflow_frame_launches(kernels)

    t0 = time.perf_counter()
    sf, kitti, ft = _write_trees(np, root)
    lines = [f"[trainer] wrote the SceneFlow tree ({SF_TRAIN} + {SF_TEST} pairs of {SF_H}x{SF_W}), "
             f"the KITTI 2015 tree ({KITTI_FRAMES} frames of {EVAL_H}x{EVAL_W}) and the FallingThings "
             f"tree ({len(FT_NAMES)} JPEG pairs of 540x960) in {time.perf_counter() - t0:.1f} s",
             _readers_line(np, root, sf, kitti, card)]
    ckpt_dir = os.path.join(root, "ckpt")
    cfg = Config(train=TrainConfig(ckpt_dir=ckpt_dir, ckpt_every=TRAINER_CKPT_EVERY))
    tcfg = cfg.train
    ds = _trainer_dataset(cfg, sf, ft)
    lines.append(_augment_line(np, root, sf, kitti, ds, card))
    inner_validate = make_train_validate_fn(cfg.model, "sceneflow", sf,
                                            max_images=TRAINER_VAL_FRAMES)
    schedule = one_cycle_schedule(tcfg.lr, tcfg.num_steps, tcfg.warmup_frac)
    log = {"steps": [], "val": [], "first": None}

    def validate_fn(state, step):
        before = _counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = inner_validate(state, step)
        torch.cuda.synchronize()
        log["val"].append((step, res, (time.perf_counter() - t0) * 1e3))
        _expect_launches(kernels, before, {k: TRAINER_VAL_FRAMES * v for k, v in per_frame.items()},
                         f"the in-training validation at step {step}")
        return res

    for k in kernels:
        k.launches = 0
    runs = []
    with _recorded_steps(torch, kernels, per_step, log, "trainer"), _counted_reads() as reads:
        for max_steps in (TRAINER_STEPS, TRAINER_RESUMED):
            log.update(first=None, wait=[])
            loader = PrefetchLoader(ds, tcfg.batch_size, num_workers=TRAINER_WORKERS, seed=tcfg.seed)
            n_steps = len(log["steps"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = trainer.train(cfg, _Timed(loader, log), validate_fn, max_steps=max_steps)
            torch.cuda.synchronize()
            runs.append(dict(state=state, first=log["first"], wall=(time.perf_counter() - t0) * 1e3,
                             steps=log["steps"][n_steps:], loader_wait=sum(log["wait"]),
                             batches=len(log["wait"])))
    # the resumed run started from the saved state, bit for bit
    saved, resumed = runs[0]["state"], runs[1]["first"]
    if resumed["step"] != TRAINER_STEPS:
        raise AssertionError(f"the second train() started at step {resumed['step']}, not {TRAINER_STEPS}")
    diff = _state_diff(_state_copy(saved), resumed)
    if diff:
        raise AssertionError(f"the resumed state differs from the saved one: {diff[:5]}")
    for step_no, ms, metrics in log["steps"]:
        loss, gnorm = float(metrics["loss"]), metrics["grad_norm"]
        if not (np.isfinite(loss) and 0 < gnorm < float("inf")) or metrics["nonfinite_skips"]:
            raise AssertionError(f"trainer step {step_no}: loss {loss}, grad_norm {gnorm}, skips "
                                 f"{metrics['nonfinite_skips']}")
        if metrics["lr"] != schedule(step_no - 1):
            raise AssertionError(f"trainer step {step_no}: lr {metrics['lr']} is not the straight "
                                 f"schedule's {schedule(step_no - 1)}")
    if [s for s, _, _ in log["steps"]] != list(range(1, TRAINER_RESUMED + 1)):
        raise AssertionError(f"trainer steps taken: {[s for s, _, _ in log['steps']]}")
    if [s for s, _, _ in log["val"]] != list(range(TRAINER_CKPT_EVERY, TRAINER_RESUMED + 1,
                                                    TRAINER_CKPT_EVERY)):
        raise AssertionError(f"validations at steps {[s for s, _, _ in log['val']]}")
    if not (reads["jpeg"] and reads["png"] and reads["progressive"]):
        raise AssertionError(f"train() decoded {reads} images: FallingThings' JPEGs (the progressive "
                             f"{FT_PROGRESSIVE} left view among them) and depth PNGs are in its mix")
    state = runs[1]["state"]
    # the loader alone: LOADER_BATCHES batches, the start of its threads included
    t0 = time.perf_counter()
    it_ = iter(PrefetchLoader(ds, tcfg.batch_size, num_workers=TRAINER_WORKERS, seed=tcfg.seed + 1))
    for _ in range(LOADER_BATCHES):
        next(it_)
    loader_rate = LOADER_RATE["prefetch"] = LOADER_BATCHES * tcfg.batch_size / (time.perf_counter() - t0)
    it_.close()
    # what bounds it: the loader maps one batch at a time, so only
    # batch_size samples are in flight; beside it one sample at a time on
    # this thread, and the loader with as many in flight as it has workers
    t0 = time.perf_counter()
    for i in range(LOADER_SERIAL):
        ds.__getitem__(i, rng=np.random.RandomState(i))
    serial_ms = (time.perf_counter() - t0) * 1e3 / LOADER_SERIAL
    t0 = time.perf_counter()
    for i in range(SF_TRAIN, SF_TRAIN + LOADER_SERIAL):  # FallingThings samples
        ds.__getitem__(i, rng=np.random.RandomState(i))
    ft_serial_ms = (time.perf_counter() - t0) * 1e3 / LOADER_SERIAL
    wide_batches = LOADER_BATCHES * tcfg.batch_size // TRAINER_WORKERS
    t0 = time.perf_counter()
    it_ = iter(PrefetchLoader(ds, TRAINER_WORKERS, num_workers=TRAINER_WORKERS, seed=tcfg.seed + 2))
    for _ in range(wide_batches):
        next(it_)
    wide_rate = wide_batches * TRAINER_WORKERS / (time.perf_counter() - t0)
    it_.close()
    # the copy of one batch to the card, as the trainer's prefetch makes it
    batch = ds.__getitem__(0, rng=np.random.RandomState(0))
    batch = {k: np.stack([v] * tcfg.batch_size) for k, v in batch.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    to_device(batch)
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) * 1e3
    # checkpoint cost, and the card's checkpoint restored on the CPU
    extra = os.path.join(root, "extra")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = save_checkpoint(extra, state)
    save_ms = (time.perf_counter() - t0) * 1e3
    mb = os.path.getsize(path) / 2**20
    fresh = create_train_state(build_model(cfg.model, seed=7), tcfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restore_checkpoint(extra, fresh)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    diff = _state_diff(_state_copy(state), _state_copy(fresh))
    on_cpu = restore_checkpoint(extra, create_train_state(build_model(cfg.model, "cpu", seed=7), tcfg, "cpu"))
    diff += _state_diff(_state_copy(state), _state_copy(on_cpu))
    if diff:
        raise AssertionError(f"a checkpoint restored on the card or the CPU differs: {diff[:5]}")
    del fresh, on_cpu
    # evaluate the checkpoint by dataset name
    before = _counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sf_metrics = run_validation(ModelConfig(), ckpt_dir, "sceneflow", sf, max_images=TRAINER_VAL_FRAMES)
    torch.cuda.synchronize()
    sf_ms = (time.perf_counter() - t0) * 1e3 / TRAINER_VAL_FRAMES
    _expect_launches(kernels, before, {k: TRAINER_VAL_FRAMES * v for k, v in per_frame.items()},
                     "run_validation on SceneFlow")
    last = log["val"][-1][1]
    if abs(sf_metrics["epe"] - last["epe"]) > EPE_ATOL:
        raise AssertionError(f"run_validation's EPE {sf_metrics['epe']} against the step-"
                             f"{TRAINER_RESUMED} validation's {last['epe']}")
    before = _counts(kernels)
    kitti_metrics = run_validation(ModelConfig(), ckpt_dir, "kitti15", kitti, max_images=KITTI_FRAMES)
    _expect_launches(kernels, before, {**dict.fromkeys(names, 0),
                                       "gather_pyramid_aligned": KITTI_FRAMES * 2 * ITERS},
                     "run_validation on KITTI 2015")
    for name, m in (("sceneflow", sf_metrics), ("kitti15", kitti_metrics)):
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad or "epe_occ" not in m:
            raise AssertionError(f"run_validation on {name}: {m}")
    launches = {k.__name__: k.launches for k in kernels}
    steps_ms = [ms for run in runs for ms in [s[1] for s in run["steps"]][1:]]  # warm-up of each run excluded
    step_ms = sum(steps_ms) / len(steps_ms)
    val_ms = [sum(v[2] for v in log["val"] if lo < v[0] <= hi)
              for lo, hi in ((0, TRAINER_STEPS), (TRAINER_STEPS, TRAINER_RESUMED))]
    wait_ms = sum(r["loader_wait"] for r in runs) / sum(r["batches"] for r in runs)
    lines.append(f"[trainer] train() from files, IGEV `ModelConfig()`, batch {tcfg.batch_size} of "
         f"{tcfg.inp_size[0]}x{tcfg.inp_size[1]} at scales {tcfg.scale_min}-{tcfg.scale_max}, Q "
         f"{tcfg.sample_q}, {it} iters, bf16: {step_ms:.2f} ms/step over {len(steps_ms)} steps "
         f"({', '.join(f'{t:.2f}' for t in steps_ms)}; the first step of each run excluded); losses "
         f"{[round(float(s[2]['loss']), 4) for s in log['steps']]}; {card}")
    runs_wall = ", ".join(f"{r['wall']:.0f}" for r in runs)
    runs_steps = ", ".join(f"{sum(s[1] for s in r['steps']):.0f}" for r in runs)
    lines.append(f"[trainer] host share: {wait_ms:.1f} ms a batch waiting on the loader and {copy_ms:.2f} ms "
         f"copying it to the card, {(wait_ms + copy_ms) / (wait_ms + copy_ms + step_ms):.1%} of a step; "
         f"train() walls {runs_wall} ms, of it steps {runs_steps} ms and validations "
         f"{', '.join(f'{v:.0f}' for v in val_ms)} ms; the loader alone {loader_rate:.2f} samples/s "
         f"({TRAINER_WORKERS} workers, {LOADER_BATCHES} batches of {tcfg.batch_size}, so {tcfg.batch_size} samples "
         f"in flight; thread start included), {wide_rate:.2f} with {TRAINER_WORKERS} in flight ({wide_batches} "
         f"batches of {TRAINER_WORKERS}), one sample alone on one thread {serial_ms:.1f} ms "
         f"({1e3 / serial_ms:.2f} samples/s) for SceneFlow and {ft_serial_ms:.1f} ms for FallingThings; "
         f"train() decoded {reads['jpeg']} JPEGs ({reads['progressive']} of them the progressive "
         f"{FT_PROGRESSIVE} left view) and {reads['png']} PNGs (the mix: {SF_TRAIN} "
         f"SceneFlow pairs and {len(FT_NAMES)} FallingThings pairs x 5); {card}")
    lines.append(f"[trainer] checkpoint {mb:.1f} MB: save {save_ms:.1f} ms, restore {restore_ms:.1f} ms; "
         f"validation {sum(v[2] for v in log['val']) / len(log['val']) / TRAINER_VAL_FRAMES:.2f} ms/frame "
         f"in training, run_validation {sf_ms:.2f} ms/frame; EPE at steps "
         f"{[(v[0], round(v[1]['epe'], 4)) for v in log['val']]}, run_validation "
         f"{sf_metrics['epe']:.4f} (SceneFlow), {kitti_metrics['epe']:.4f} (KITTI, epe_occ "
         f"{kitti_metrics['epe_occ']:.4f}); launches {({k: v for k, v in launches.items() if v})}; {card}")
    for line in lines:
        _log(line)
    # kept beside kernels.json: the kernels line pushes these out of a log
    # that keeps only the end of the output
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "trainer.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return launches, sf, kitti, ft


def _trainer_dataset(cfg, sf, ft):
    """`fetch_dataset(["sceneflow", "falling_things"])` on the trees, in
    multi-scale mode at `cfg`'s crop and scales (FallingThings x 5)."""
    from anystereo_tpu_torch.data.augment import AugmentorConfig
    from anystereo_tpu_torch.data.datasets import fetch_dataset

    tcfg = cfg.train
    aug = AugmentorConfig(crop_size=tcfg.inp_size, yjitter=cfg.data.yjitter)
    ds = fetch_dataset(["sceneflow", "falling_things"], {"sceneflow": sf, "falling_things": ft}, aug,
                       multi_scale=tcfg.multi_scale, scale_min=tcfg.scale_min, scale_max=tcfg.scale_max,
                       inp_size=tcfg.inp_size)
    if len(ds) != SF_TRAIN + 5 * len(FT_NAMES):
        raise AssertionError(f"fetch_dataset found {len(ds)} training samples, not {SF_TRAIN} SceneFlow "
                             f"pairs and FallingThings' {len(FT_NAMES)} x 5")
    return ds


@contextlib.contextmanager
def _recorded_steps(torch, kernels, per_step, log, what):
    """`train()`'s training step, wrapped while the block runs: each step
    synchronised and timed, its launches held to `per_step` exactly, and
    recorded in log["steps"] as (step, ms, metrics); where log["first"] is
    None, the state as `train()` hands it to its first step goes there;
    where log has "digests", (step, `_batch_digest` of its batch) goes there."""
    from anystereo_tpu_torch.train import trainer

    real_make = trainer.make_train_step

    def timed_make(*args, **kwargs):
        step_fn = real_make(*args, **kwargs)

        def step(state, batch):
            if "first" in log and log["first"] is None:
                log["first"] = _state_copy(state)
            if "digests" in log:
                log["digests"].append((state.step + 1, _batch_digest(batch)))
            before = _counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            log["steps"].append((state.step, (time.perf_counter() - t0) * 1e3, metrics))
            _expect_launches(kernels, before, per_step, f"{what} step {state.step}")
            return state, metrics

        return step

    trainer.make_train_step = timed_make
    try:
        yield
    finally:
        trainer.make_train_step = real_make


class _Timed:
    """A loader whose iterator records, in log["wait"], how long each fetch
    of a batch took."""

    def __init__(self, loader, log):
        self.loader, self.log = loader, log

    def __iter__(self):
        it = iter(self.loader)
        try:
            while True:
                t0 = time.perf_counter()
                batch = next(it)
                self.log["wait"].append((time.perf_counter() - t0) * 1e3)
                yield batch
        finally:
            it.close()


def _batch_digest(batch):
    """A digest of a batch's keys and bytes, copied from the card."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(k.encode())
        h.update(batch[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _state_copy(state):
    """A host copy of a train state's parameters, moments and counters."""
    opt = state.optimizer
    return {"step": state.step, "count": opt.count, "skips": (opt.notfinite_count, opt.total_notfinite),
            "params": {n: p.detach().cpu().clone() for n, p in state.model.named_parameters()},
            "buffers": {n: b.detach().cpu().clone() for n, b in state.model.named_buffers()},
            "mu": [m.cpu().clone() for m in opt.mu], "nu": [m.cpu().clone() for m in opt.nu]}


def _state_diff(a, b):
    """The names of what differs between two `_state_copy`s, bit for bit."""
    import torch

    out = [k for k in ("step", "count", "skips") if a[k] != b[k]]
    for group in ("params", "buffers"):
        out += [f"{group}.{n}" for n in a[group] if not torch.equal(a[group][n], b[group][n])]
    out += [f"mu[{i}]" for i, (x, y) in enumerate(zip(a["mu"], b["mu"])) if not torch.equal(x, y)]
    out += [f"nu[{i}]" for i, (x, y) in enumerate(zip(a["nu"], b["nu"])) if not torch.equal(x, y)]
    return out


# ----------------------------------------------------------------- phase 8

LOADER_STEPS = 4  # the straight run; the preempted run stops halfway and resumes to it
LOADER_RATE = {}  # samples/s of a loader alone, TRAINER_WORKERS workers, batch 2: "prefetch", "grain"


def phase_loader(torch, kernels, card, root, sf, ft):
    """The checkpointable loader (`data/grain_loader.py`, `--loader grain`)
    on the trainer phase's trees and dataset, TRAINER_WORKERS worker
    processes, seed 1234 (`TrainConfig()`): `train()` straight for
    LOADER_STEPS steps with a checkpoint every LOADER_STEPS // 2, and a run
    preempted there (its loader state written beside the checkpoint) that a
    fresh `train()` resumes to LOADER_STEPS.  The resumed run's first state
    must be the saved one bit for bit, and every batch its steps consume
    must be the straight run's (a digest of the bytes on the card); the
    launches of every step exact.  Then `cli.main(["train", "--loader",
    "grain", ...])` for CLI_STEPS steps, which must exit 0 and write its
    loader state; and the loader's samples/s alone beside the trainer
    phase's `PrefetchLoader`."""
    from anystereo_tpu_torch import cli
    from anystereo_tpu_torch.config import Config, TrainConfig
    from anystereo_tpu_torch.data.grain_loader import GrainLoader
    from anystereo_tpu_torch.train import trainer
    from anystereo_tpu_torch.train.state import checkpoint_steps

    t_phase = time.perf_counter()
    per_step = _igev_step_launches(kernels)
    half = LOADER_STEPS // 2
    straight, preempted, by_cli = (os.path.join(root, d) for d in ("grain_a", "grain_b", "grain_cli"))
    tcfg = TrainConfig()
    ds = _trainer_dataset(Config(train=tcfg), sf, ft)
    for k in kernels:
        k.launches = 0
    log = {"steps": []}
    runs = []
    with _recorded_steps(torch, kernels, per_step, log, "loader"):
        for ckpt, max_steps in ((straight, LOADER_STEPS), (preempted, half), (preempted, LOADER_STEPS)):
            cfg = Config(train=TrainConfig(ckpt_dir=ckpt, ckpt_every=half))
            log.update(first=None, digests=[])
            n_steps = len(log["steps"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = trainer.train(cfg, GrainLoader(ds, tcfg.batch_size, num_workers=TRAINER_WORKERS,
                                                   seed=tcfg.seed), max_steps=max_steps)
            torch.cuda.synchronize()
            runs.append(dict(state=state, first=log["first"], digests=log["digests"],
                             steps=[s for s, _, _ in log["steps"][n_steps:]],
                             ms=[ms for _, ms, _ in log["steps"][n_steps:]],
                             wall=(time.perf_counter() - t0) * 1e3))
        sidecar = os.path.join(preempted, f"loader_state-{half}-p0.bin")
        if not os.path.exists(sidecar):
            raise AssertionError(f"the preempted run wrote no {sidecar}")
        log.update(first=None, digests=[])
        n_steps = len(log["steps"])
        t0 = time.perf_counter()
        rc = cli.main(["train", "--loader", "grain", "--datasets", "sceneflow", "--data-root", sf,
                       "--num-steps", str(CLI_STEPS), "--num-workers", str(TRAINER_WORKERS), "--ckpt-dir", by_cli])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    cli_steps = [s for s, _, _ in log["steps"][n_steps:]]
    if (rc != 0 or cli_steps != list(range(1, CLI_STEPS + 1)) or checkpoint_steps(by_cli) != [CLI_STEPS]
            or not os.path.exists(os.path.join(by_cli, f"loader_state-{CLI_STEPS}-p0.bin"))):
        raise AssertionError(f"cli train --loader grain: exit {rc}, steps {cli_steps}, checkpoints "
                             f"{checkpoint_steps(by_cli)}, files {sorted(os.listdir(by_cli))}")
    a, b1, b2 = runs
    for run, want in ((a, range(1, LOADER_STEPS + 1)), (b1, range(1, half + 1)),
                      (b2, range(half + 1, LOADER_STEPS + 1))):
        if run["steps"] != list(want):
            raise AssertionError(f"loader runs took steps {[r['steps'] for r in runs]}")
    if b2["first"]["step"] != half:
        raise AssertionError(f"the resumed train() started at step {b2['first']['step']}, not {half}")
    diff = _state_diff(_state_copy(b1["state"]), b2["first"])
    if diff:
        raise AssertionError(f"the resumed state differs from the saved one: {diff[:5]}")
    if b1["digests"] + b2["digests"] != a["digests"]:
        raise AssertionError(f"the preempted and resumed runs consumed {b1['digests'] + b2['digests']}, "
                             f"the straight run {a['digests']}")
    for step_no, _, metrics in log["steps"]:
        loss = float(metrics["loss"])
        if not (loss == loss and abs(loss) != float("inf")) or metrics["nonfinite_skips"]:
            raise AssertionError(f"loader step {step_no}: loss {loss}, skips {metrics['nonfinite_skips']}")
    launches = {k.__name__: k.launches for k in kernels}
    # the loader alone, as the trainer phase times `PrefetchLoader`: the
    # start of its worker processes included
    t0 = time.perf_counter()
    it_ = iter(GrainLoader(ds, tcfg.batch_size, num_workers=TRAINER_WORKERS, seed=tcfg.seed + 1))
    next(it_)
    first_s = time.perf_counter() - t0
    for _ in range(LOADER_BATCHES - 1):
        next(it_)
    rate = LOADER_RATE["grain"] = LOADER_BATCHES * tcfg.batch_size / (time.perf_counter() - t0)
    it_.close()
    prefetch = LOADER_RATE.get("prefetch")
    steps_ms = [ms for run in runs for ms in run["ms"][1:]]  # the first step of each run excluded
    _keep("loader", f"[loader] GrainLoader ({TRAINER_WORKERS} worker processes, seed {tcfg.seed}, batch "
          f"{tcfg.batch_size}) through train(): straight {LOADER_STEPS} steps in {a['wall']:.0f} ms, preempted at "
          f"{half} in {b1['wall']:.0f} ms and resumed to {LOADER_STEPS} in {b2['wall']:.0f} ms (model, workers' "
          f"start and checkpoints included), {sum(steps_ms) / len(steps_ms):.2f} ms/step over {len(steps_ms)} "
          f"steps (the first of each run excluded); the resumed state bit for bit the saved one; steps "
          f"{half + 1}-{LOADER_STEPS} consumed the straight run's batches {[d for _, d in b2['digests']]}; "
          f"cli train --loader grain {CLI_STEPS} steps: exit 0 in {cli_s:.1f} s, its loader state written; "
          f"the loader alone {rate:.2f} samples/s ({LOADER_BATCHES} batches of {tcfg.batch_size}, first batch "
          f"{first_s:.1f} s after the start), PrefetchLoader "
          f"{'not measured' if prefetch is None else f'{prefetch:.2f}'} samples/s (the trainer phase, "
          f"{TRAINER_WORKERS} threads, {tcfg.batch_size} samples in flight); phase "
          f"{time.perf_counter() - t_phase:.1f} s; launches {({k: v for k, v in launches.items() if v})}; "
          f"{card}")
    return launches


# ----------------------------------------------------------------- phases 9-11


HERE = os.path.dirname(os.path.abspath(__file__))
CLI_STEPS = 2
DDP_RANKS, DDP_VALID_SHARE = 2, 0.25  # sample 1 of the ddp batch has a quarter of its queries valid
# both ranks share the one card, and NCCL refuses two ranks on one device
DDP_BACKEND = "gloo"
# one step of two ranks against one process on the same batch of two (fp32,
# cuDNN deterministic): the forward agrees bit for bit, but cuDNN reduces a
# weight gradient over a batch of two in another order than two batches of
# one and a sum, and where a convolution feeds a normalisation the gradient
# is the small rest of large terms: 5.0e-3 of a 3-D convolution's gradient,
# and Adam's first, sign-like step turns it into 5.5e-2 of that tensor's
# update (NVIDIA H100 80GB HBM3, 700.00 W; cuDNN off: 1.2e-3 and 5.3e-2).
# A tensor the ranks did not reduce is off by about its whole gradient and
# update.
DDP_LOSS_RTOL, DDP_GRAD_RTOL, DDP_MODEL_RTOL, DDP_UPDATE_RTOL = 1e-5, 2e-2, 1e-5, 0.25


def _keep(phase, line):
    """Log a phase's line and keep it in OUT_DIR/<phase>.txt: the kernels
    line pushes it out of a log that keeps only the end of the output."""
    _log(line)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{phase}.txt"), "w") as f:
        f.write(line + "\n")


def _reference_state_dict(np, torch, seed=11):
    """A seeded reference-format IGEV state_dict at `ModelConfig()` widths:
    its keys and shapes are the committed manifest's
    (`tests/data/reference_keys_igev.json`, what the JAX package's converter
    reads), fan-in scaled weights, BatchNorm scales near 1 and variances in
    [0.5, 1.5]."""
    with open(os.path.join(HERE, "tests", "data", "reference_keys_igev.json")) as f:
        keys = json.load(f)["keys"]
    rng = np.random.RandomState(seed)
    sd = {}
    for key, shape, dtype in keys:
        if dtype == "int64":
            v = np.asarray(rng.randint(0, 1000), np.int64)
        elif key.endswith(".running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif key.endswith(".weight") and len(shape) >= 2:
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif key.endswith(".weight"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:
            v = 0.1 * rng.randn(*shape)
        sd[key] = torch.from_numpy(np.asarray(v, np.float32 if dtype == "float32" else np.int64))
    return sd


def _metric_lines(text, what):
    """The `name: value` lines the CLI's evaluate prints, as a dict; all
    finite, `epe` among them."""
    out = {}
    for line in text.splitlines():
        name, sep, value = line.partition(": ")
        if sep and name.replace("_", "").isalnum():
            out[name] = float(value)
    if "epe" not in out or not all(v == v and abs(v) != float("inf") for v in out.values()):
        raise AssertionError(f"{what} printed no finite metrics: {text[-2000:]}")
    return out


def phase_convert(torch, kernels, card, root, kitti):
    """Reference-checkpoint import: a seeded reference IGEV `.pth` (`module.`
    prefix, `{"model": ...}` wrapper) → `python -m
    anystereo_tpu_torch.tools.convert_checkpoint --verify` (a subprocess; its
    forward runs on the card) → the result loaded strictly into a
    reference-regime model on the card and held to this process's converter
    tensor for tensor → `run_validation(reference_regime_config(), ...)` on
    the KITTI tree, with B1 64 launches a frame exactly.  Returns the
    launches and the converted checkpoint's directory."""
    import re

    import numpy as np

    from anystereo_tpu_torch.config import reference_regime_config
    from anystereo_tpu_torch.eval.validate import run_validation
    from anystereo_tpu_torch.nn.model import build_model
    from anystereo_tpu_torch.train.state import CHECKPOINT_FILE
    from anystereo_tpu_torch.utils.torch_convert import convert_state_dict

    sd = _reference_state_dict(np, torch)
    ref = os.path.join(root, "reference.pth")
    torch.save({"model": {"module." + k: v for k, v in sd.items()}}, ref)
    out = os.path.join(root, "converted")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "anystereo_tpu_torch.tools.convert_checkpoint",
                           "--torch-ckpt", ref, "--out", out, "--verify"],
                          cwd=HERE, capture_output=True, text=True, timeout=600)
    tool_s = time.perf_counter() - t0
    if proc.returncode != 0 or "verify: forward finite OK" not in proc.stdout:
        raise AssertionError(f"convert_checkpoint failed ({proc.returncode}): {proc.stdout[-2000:]}"
                             f"{proc.stderr[-3000:]}")
    convert_ms = float(re.search(r" in ([0-9.]+) ms", proc.stdout).group(1))
    cfg = reference_regime_config()
    saved = torch.load(os.path.join(out, "0", CHECKPOINT_FILE), map_location="cpu", weights_only=True)
    model = build_model(cfg, DEVICE)
    model.load_state_dict(saved["model"], strict=True)
    del model
    want = convert_state_dict(sd, cfg)
    if sorted(want) != sorted(saved["model"]) or [k for k in want if not torch.equal(want[k], saved["model"][k])]:
        raise AssertionError("the tool's checkpoint differs from the converter's tensors")
    names = [k.__name__ for k in kernels]
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = run_validation(cfg, out, "kitti15", kitti, max_images=KITTI_FRAMES)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3 / KITTI_FRAMES
    _expect_launches(kernels, [0] * len(kernels),
                     {**dict.fromkeys(names, 0), "gather_pyramid_aligned": KITTI_FRAMES * 2 * ITERS},
                     "run_validation of the converted checkpoint on KITTI 2015")
    if not all(np.isfinite(v) for v in metrics.values()) or "epe_occ" not in metrics:
        raise AssertionError(f"run_validation of the converted checkpoint: {metrics}")
    launches = {k.__name__: k.launches for k in kernels}
    _keep("convert", f"[convert] reference IGEV state_dict of {len(sd)} tensors ({sum(v.numel() for v in sd.values())} "
         f"values) -> {len(saved['model'])} tensors of the port: {convert_ms:.1f} ms converting, the tool "
         f"{tool_s:.1f} s with its start and its --verify forward on the card; loaded strictly, equal to this "
         f"process's converter; run_validation (reference regime) on KITTI 2015: {frame_ms:.2f} ms/frame, epe "
         f"{metrics['epe']:.4f}, d1 {metrics['d1']:.4f} (random weights); launches "
         f"{({k: v for k, v in launches.items() if v})}; {card}")
    return launches, out


def phase_cli(torch, kernels, card, root, sf, kitti, converted):
    """The command line: `cli.main(["train", ...])` in this process at
    `TrainConfig()` defaults on the SceneFlow tree, warm started from the
    converted checkpoint (`--restore`), for CLI_STEPS steps with the exact
    launches of each.  The CLI builds the GroupNorm model (as the JAX CLI
    does), so only the tensors that fit it load: the warm start must warn
    about the converted BatchNorm tensors that find no home.  Then `cli.main(["evaluate", ...])` of its checkpoint on
    SceneFlow with the exact launches of each frame; then one `python -m
    anystereo_tpu_torch.cli evaluate` subprocess on KITTI 2015, which must
    exit 0 and print finite metrics."""
    import io

    from anystereo_tpu_torch import cli
    from anystereo_tpu_torch.train.state import checkpoint_steps

    per_step = _igev_step_launches(kernels)
    per_frame = _sceneflow_frame_launches(kernels)
    ckpt = os.path.join(root, "cli_ckpt")
    for k in kernels:
        k.launches = 0
    log = {"steps": []}
    unloaded = _Warnings("anystereo_tpu_torch.train.state", "fit no parameter")
    t0 = time.perf_counter()
    with unloaded, _recorded_steps(torch, kernels, per_step, log, "cli train"):
        rc = cli.main(["train", "--datasets", "sceneflow", "--data-root", sf, "--restore", converted,
                       "--num-steps", str(CLI_STEPS), "--num-workers", str(TRAINER_WORKERS), "--ckpt-dir", ckpt])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    steps = [s for s, _, _ in log["steps"]]
    if rc != 0 or steps != list(range(1, CLI_STEPS + 1)) or checkpoint_steps(ckpt) != [CLI_STEPS]:
        raise AssertionError(f"cli train: exit {rc}, steps {steps}, checkpoints {checkpoint_steps(ckpt)}")
    if len(unloaded.args) != 1:
        raise AssertionError(f"cli train --restore <converted>: {len(unloaded.args)} warnings of tensors "
                             "not loaded, expected 1 (the GroupNorm model)")
    (_, n_unloaded, n_donor, *_), = unloaded.args
    for step_no, _, metrics in log["steps"]:
        loss = float(metrics["loss"])
        if not (loss == loss and abs(loss) != float("inf")) or metrics["nonfinite_skips"]:
            raise AssertionError(f"cli train step {step_no}: loss {loss}, skips {metrics['nonfinite_skips']}")
    before = _counts(kernels)
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["evaluate", "--dataset", "sceneflow", "--data-root", sf, "--ckpt", ckpt])
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3 / SF_TEST
    if rc != 0:
        raise AssertionError(f"cli evaluate exited {rc}")
    _expect_launches(kernels, before, {k: SF_TEST * v for k, v in per_frame.items()},
                     "cli evaluate on SceneFlow")
    sf_metrics = _metric_lines(buf.getvalue(), "cli evaluate")
    launches = {k.__name__: k.launches for k in kernels}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "anystereo_tpu_torch.cli", "evaluate", "--dataset", "kitti15",
                           "--data-root", kitti, "--ckpt", ckpt], cwd=HERE, capture_output=True, text=True,
                          timeout=600)
    sub_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python -m anystereo_tpu_torch.cli evaluate exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    kitti_metrics = _metric_lines(proc.stdout, "python -m anystereo_tpu_torch.cli evaluate")
    step_ms = [ms for _, ms, _ in log["steps"]]
    _keep("cli", f"[cli] train --restore <converted> --num-steps {CLI_STEPS} at TrainConfig() defaults (the "
         f"CLI's GroupNorm model: {n_unloaded} of the {n_donor} converted tensors do not fit it and were not "
         f"loaded, with the warning): {', '.join(f'{ms:.2f}' for ms in step_ms)} ms a step, {train_s:.1f} s in all (the loader's start, "
         f"the warm start and the checkpoint included); losses "
         f"{[round(float(m['loss']), 4) for _, _, m in log['steps']]}; evaluate on SceneFlow in this process "
         f"{eval_ms:.2f} ms/frame, epe {sf_metrics['epe']:.4f}; `python -m anystereo_tpu_torch.cli evaluate` on "
         f"KITTI 2015: exit 0 in {sub_s:.1f} s, epe {kitti_metrics['epe']:.4f}; launches "
         f"{({k: v for k, v in launches.items() if v})}; {card}")
    return launches


class _Warnings:
    """Within `with`, the arguments of every warning of the logger `name`
    whose message holds `text`."""

    def __init__(self, name, text):
        import logging

        self.logger, self.text, self.args = logging.getLogger(name), text, []
        outer = self

        class Handler(logging.Handler):
            def emit(self, record):
                if outer.text in str(record.msg):
                    outer.args.append(record.args)

        self.handler = Handler(logging.WARNING)

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def _launch_counters():
    """Every kernel wrapper that counts launches (B1-B8, forward and
    backward)."""
    from anystereo_tpu_torch.utils.profiling import kernel_wrappers

    return list(kernel_wrappers().values())


def _ddp_config(ckpt_dir, batch, data):
    from anystereo_tpu_torch.config import Config, MeshConfig, ModelConfig, TrainConfig

    return Config(model=ModelConfig(compute_dtype="float32"), mesh=MeshConfig(data=data),
                  train=TrainConfig(batch_size=batch, ckpt_dir=ckpt_dir))


def _ddp_train(torch, kernels, cfg, batch, what):
    """One step of `train()` on `batch` (numpy); returns its metrics, its ms
    (synchronised), the launches, and the parameters and the gradient the
    optimizer applied, on the host."""
    from anystereo_tpu_torch.train import trainer

    for k in kernels:
        k.launches = 0
    log = {"steps": []}
    with _recorded_steps(torch, kernels, _igev_step_launches(kernels), log, what):
        state = trainer.train(cfg, [batch], max_steps=1)
    (_, ms, metrics), = log["steps"]
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "ms": ms,
            "launches": {k.__name__: k.launches for k in kernels},
            "params": {n: p.detach().cpu() for n, p in state.model.named_parameters()},
            "grads": {n: p.grad.cpu() for n, p in state.model.named_parameters()}}


def _ddp_rank(rank, port, root):
    """One rank of the ddp phase, in its own process on the one card."""
    import numpy as np
    import torch

    _fp32_deterministic(torch)
    torch.distributed.init_process_group(DDP_BACKEND, init_method=f"tcp://127.0.0.1:{port}",
                                         world_size=DDP_RANKS, rank=rank)
    try:
        batch = {k: v[rank:rank + 1] for k, v in np.load(os.path.join(root, "ddp_batch.npz")).items()}
        res = _ddp_train(torch, _launch_counters(), _ddp_config(os.path.join(root, "ddp_ranks"), 1, 0), batch,
                         f"ddp rank {rank}")
        torch.save(res, os.path.join(root, f"ddp_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_ddp(torch, kernels, card, root):
    """Data-parallel training: DDP_RANKS ranks on the one card
    (`torch.multiprocessing`, the process group over DDP_BACKEND), each with
    one sample of a seeded synthetic batch of two whose valid counts differ,
    one step of `train()` at full width (`ModelConfig()`, `TrainConfig()`:
    160x320, 51,200 queries a sample, 16 iterations) in fp32 (cuDNN
    deterministic); against one process on the same batch of two.  The loss
    within DDP_LOSS_RTOL, every gradient the optimizer applied within
    DDP_GRAD_RTOL, the parameters after the step within DDP_MODEL_RTOL of
    the model's norm and each tensor within DDP_UPDATE_RTOL of its update,
    the two replicas equal; only rank 0 writes the checkpoint; each rank's
    launches are exact and come back with its results."""
    import numpy as np

    from anystereo_tpu_torch.config import TrainConfig
    from anystereo_tpu_torch.nn.model import build_model
    from anystereo_tpu_torch.train.state import checkpoint_steps

    _fp32_deterministic(torch)
    q = TrainConfig().sample_q
    batch = {k: v.cpu().numpy() for k, v in _train_batch(torch, 2, TRAIN_H, TRAIN_W, q, seed=6).items()}
    rng = np.random.RandomState(6)
    batch["valid"][1] = 0
    batch["valid"][1, rng.permutation(q)[: int(q * DDP_VALID_SHARE)]] = 1
    np.savez(os.path.join(root, "ddp_batch.npz"), **batch)
    want = _ddp_train(torch, kernels, _ddp_config(os.path.join(root, "ddp_one"), 2, 1), batch, "ddp one process")
    start = dict(build_model(_ddp_config("", 2, 1).model, "cpu", seed=TrainConfig().seed).named_parameters())
    torch.cuda.empty_cache()
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_ddp_rank, args=(r, port, root)) for r in range(DDP_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    wall = time.perf_counter() - t0
    for p in procs:
        if p.is_alive():
            p.kill()
    codes = [p.exitcode for p in procs]
    if codes != [0] * DDP_RANKS:
        raise AssertionError(f"ddp ranks exited {codes}")
    ranks = [torch.load(os.path.join(root, f"ddp_rank{r}.pt"), weights_only=True) for r in range(DDP_RANKS)]
    if checkpoint_steps(os.path.join(root, "ddp_ranks")) != [1]:
        raise AssertionError("the ranks' checkpoint directory does not hold step 1 alone")
    loss = want["metrics"]["loss"]
    rel = [abs(r["metrics"]["loss"] - loss) / abs(loss) for r in ranks]
    grad = [_grad_diff(r["grads"], want["grads"], DDP_GRAD_RTOL) for r in ranks]
    norm = torch.linalg.vector_norm
    upd = sorted(((float(norm(ranks[0]["params"][n] - w) / norm(w - start[n].detach()).clamp_min(1e-30)), n)
                  for n, w in want["params"].items()), reverse=True)
    model_rel = float(norm(torch.stack([norm(ranks[0]["params"][n] - w) for n, w in want["params"].items()]))
                      / norm(torch.stack([norm(w) for w in want["params"].values()])))
    same = all(torch.equal(ranks[0]["params"][n], ranks[1]["params"][n]) for n in want["params"])
    launches = {name: want["launches"][name] + sum(r["launches"][name] for r in ranks) for name in want["launches"]}
    rank_ms = ", ".join(f"{r['ms']:.2f}" for r in ranks)
    _keep("ddp", f"[ddp] {DDP_RANKS} ranks over {DDP_BACKEND} on one card, a sample each (valid queries "
         f"{int(batch['valid'][0].sum())} and {int(batch['valid'][1].sum())}), against one process on both, "
         f"fp32, one train() step at TrainConfig() shapes: loss {loss:.6f}, ranks' relative difference "
         f"{max(rel):.2e} (bound {DDP_LOSS_RTOL}); worst ||dg||/||g|| {max(g[0] for g in grad):.2e} "
         f"({grad[0][1]}; bound {DDP_GRAD_RTOL}); parameters after the step: the model within "
         f"{model_rel:.2e} of its norm (bound {DDP_MODEL_RTOL}), worst ||dp||/||update|| {upd[0][0]:.2e} "
         f"({upd[0][1]}; bound {DDP_UPDATE_RTOL}), next "
         f"{[(round(v, 4), n) for v, n in upd[1:4]]}; replicas equal: {same}; ms per step: one process "
         f"{want['ms']:.2f}, ranks {rank_ms} ({wall:.1f} s for the ranks' "
         f"processes in all); launches {({k: v for k, v in launches.items() if v})}; {card}")
    if (max(rel) > DDP_LOSS_RTOL or any(g[2] for g in grad) or not same or model_rel > DDP_MODEL_RTOL
            or upd[0][0] > DDP_UPDATE_RTOL):
        raise AssertionError(f"data-parallel step against one process: loss {rel}, gradients "
                             f"{[g[2][:5] for g in grad]}, replicas equal {same}, parameters {model_rel} of "
                             f"the model's norm, {upd[:3]} of their updates")
    return launches


# ----------------------------------------------------------------- phase 12

SPATIAL_H, SPATIAL_W, SPATIAL_RANKS = 1504, 2016, 2  # a Middlebury-F-class frame over two ranks
SPATIAL_QUERIES = 200_000  # the scattered query request, seeded over the frame
# the bf16 band of the JAX package's sharded forward (tests/test_spatial.py):
# |tiled - one process| <= atol + rtol * |one process|
SPATIAL_ATOL = SPATIAL_RTOL = 5e-2
# and its median under 0.2 px.  The bound lies between two readings the
# phase takes of the one process's own forward: the tiled arithmetic on a
# one-rank group, with no split at all (`one_rank`), where a rounding-level
# change of the bf16 forward compounds over 32 iterations to a median of
# ~0.14 px at |ref| ~163 px; and a planted fault, the frame's rows computed
# in reverse order and flipped back (`flipped_rows`), which must read above
# the bound, or the phase fails
SPATIAL_MEDIAN_PX = 0.2
# each rank's peak device memory against one process's: two ranks ideally
# hold half, plus the replicated weights and the halos
SPATIAL_PEAK_SHARE = 0.7


@contextlib.contextmanager
def _precision_kept(torch):
    """The precision flags the phases set (TF32 in cuDNN and in cuBLAS's
    matmuls, cuDNN's deterministic algorithms) back as they were after the
    block, so that no later phase inherits them."""
    b = torch.backends
    kept = b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic = kept


def _default_precision(torch):
    """PyTorch's own defaults: TF32 in cuDNN, cuDNN's fastest algorithms."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = False


def _spatial_requests(torch, kernels, forward, latents, what):
    """One warm-up and REQUESTS timed dense requests of the 1504x2016 frame,
    then one request at SPATIAL_QUERIES seeded queries, each with its exact
    launches (B1 two an iteration; the query decode one row gather a latent
    and one for the disparity taps).  `forward(coords, stats)` returns the
    disparity; the counts are set to 0 just before.  Returns the times, the
    collectives of each timed request, the launches, the outputs and the
    peak memory over the requests."""
    want = dict.fromkeys((k.__name__ for k in kernels), 0)
    want["gather_pyramid_aligned"] = 2 * ITERS
    for k in kernels:
        k.launches = 0
    times, stats = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + REQUESTS):
        before, st = _counts(kernels), {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense = forward(None, st)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
            stats.append(st)
        _expect_launches(kernels, before, want, f"{what}, dense request {i}")
    g = torch.Generator(device=DEVICE).manual_seed(8)
    coords = torch.rand(1, SPATIAL_QUERIES, 2, device=DEVICE, generator=g) * 2 - 1
    before, st = _counts(kernels), {}
    queries = forward(coords, st)
    _expect_launches(kernels, before, dict(want, gather_rows=latents + 1), f"{what}, query request")
    torch.cuda.synchronize()
    for out, shape in ((dense, (1, SPATIAL_H, SPATIAL_W)), (queries, (1, SPATIAL_QUERIES))):
        if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{what}: disparity {tuple(out.shape)} not finite {list(shape)}")
    return {"ms": times, "stats": stats, "query_stats": st, "peak": torch.cuda.max_memory_allocated(),
            "launches": {k.__name__: k.launches for k in kernels}, "dense": dense.cpu(), "queries": queries.cpu()}


def _spatial_side(torch, kernels, forward_of, what, floor=False):
    """The bf16 requests (`_spatial_requests`) of a model at `ModelConfig()`
    built from seed 0, and the fp32 check: the 1x384x1248 pair, CHECK_ITERS
    iterations, TF32 off, cuDNN deterministic; the precision flags as they
    were after it.  `forward_of(model, left, right, iters)` gives
    `forward(coords, stats)`.  `floor`: also the median |Δ| of the dense
    request from the same frame in a batch of two, from a spatial context of
    one rank, and from the row-flipped frame flipped back (a planted
    fault)."""
    from anystereo_tpu_torch.nn.model import build_model
    from anystereo_tpu_torch.parallel.spatial import infer_spatial_sharded

    with _precision_kept(torch):
        _default_precision(torch)
        base = torch.cuda.memory_allocated()
        model = build_model(_config("igev"), device=DEVICE, seed=0)
        left, right = _spatial_images(torch)
        res = _spatial_requests(torch, kernels, forward_of(model, left, right, ITERS), len(model.liif.posencs),
                                what)
        res["peak"] -= base
        if floor:
            # the one process's own noise: the same frame in a batch of two; and
            # the tiled arithmetic with no split: a spatial context of one rank
            pair = forward_of(model, torch.cat([left, left]), torch.cat([right, right]), ITERS)(None, {})
            res["floor"] = float((pair[:1].cpu() - res["dense"]).abs().median())
            del pair
            flipped = forward_of(model, left.flip(1), right.flip(1), ITERS)(None, {}).flip(1)
            res["flipped_rows"] = float((flipped.cpu() - res["dense"]).abs().median())
            del flipped
            torch.distributed.init_process_group(DDP_BACKEND, init_method=f"tcp://127.0.0.1:{_free_port()}",
                                                 world_size=1, rank=0)
            try:
                one_rank = infer_spatial_sharded(model, None, left, right, None, None, None, iters=ITERS)
            finally:
                torch.distributed.destroy_process_group()
            res["one_rank"] = float((one_rank.cpu() - res["dense"]).abs().median())
        del model, left, right
        torch.cuda.empty_cache()
        _fp32_deterministic(torch)
        model = build_model(_config("igev", compute_dtype="float32"), device=DEVICE, seed=0)
        left, right = _images(torch, 1)
        res["check"] = forward_of(model, left, right, CHECK_ITERS)(None, {}).cpu()
        return res


def _spatial_images(torch):
    g = torch.Generator(device=DEVICE).manual_seed(4)
    left = torch.rand(1, SPATIAL_H, SPATIAL_W, 3, device=DEVICE, generator=g) * 255
    return left, torch.roll(left, shifts=-24, dims=2)


def _spatial_rank(rank, port, root):
    """One rank of the spatial phase, in its own process on the one card:
    `infer_spatial_sharded` over the group of both ranks (gloo)."""
    import torch

    from anystereo_tpu_torch.parallel.spatial import infer_spatial_sharded

    torch.distributed.init_process_group(DDP_BACKEND, init_method=f"tcp://127.0.0.1:{port}",
                                         world_size=SPATIAL_RANKS, rank=rank)
    try:
        def forward_of(model, left, right, iters):
            return lambda coords, stats: infer_spatial_sharded(model, None, left, right, coords, None, None,
                                                               iters=iters, stats=stats)

        res = _spatial_side(torch, _launch_counters(), forward_of, f"spatial rank {rank}")
        torch.save(res, os.path.join(root, f"spatial_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def phase_spatial(torch, kernels, card, root):
    """H-tiled spatial inference: SPATIAL_RANKS ranks on the one card
    (`torch.multiprocessing`, gloo: NCCL refuses two ranks on one device)
    run `infer_spatial_sharded` on the IGEV model at `ModelConfig()`, bf16,
    ITERS iterations, at the SPATIAL_H x SPATIAL_W frame (one warm-up and
    REQUESTS dense requests, then one at SPATIAL_QUERIES scattered queries),
    and the same in one process: ms per request, each rank's peak memory
    against the one process's (under SPATIAL_PEAK_SHARE), the collectives of
    a request and their summed time, exact launches (B1 64 a request, the
    row gather once a latent and once for the disparity taps at the
    queries).  The bf16 outputs within the JAX package's band of its own
    sharded forward and a median under SPATIAL_MEDIAN_PX, beside the one
    process's own median |Δ| from a batch of two, from a one-rank spatial
    context (the tiled arithmetic with no split) and from the planted
    row-flip fault (which must exceed the bound), and an fp32 check (1x384x1248,
    CHECK_ITERS iterations, TF32 off, cuDNN deterministic) within
    MODEL_CHECK_ATOL px."""
    from anystereo_tpu_torch.parallel.spatial import row_partition

    def forward_of(model, left, right, iters):
        return lambda coords, stats: model(left, right, iters=iters, coords=coords).disp_final

    want = _spatial_side(torch, kernels, forward_of, "spatial, one process", floor=True)
    torch.cuda.empty_cache()
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_spatial_rank, args=(r, port, root)) for r in range(SPATIAL_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    wall = time.perf_counter() - t0
    for p in procs:
        if p.is_alive():
            p.kill()
    codes = [p.exitcode for p in procs]
    if codes != [0] * SPATIAL_RANKS:
        raise AssertionError(f"spatial ranks exited {codes}")
    ranks = [torch.load(os.path.join(root, f"spatial_rank{r}.pt"), weights_only=True) for r in range(SPATIAL_RANKS)]
    fails, lines = [], []
    for r, res in enumerate(ranks):
        check = float((res["check"] - want["check"]).abs().max())
        diffs = {}
        for key in ("dense", "queries"):
            d, ref = (res[key] - want[key]).abs(), want[key].abs()
            diffs[key] = (float(d.median()), float(d.max()), float((d - SPATIAL_RTOL * ref).max()))
        share = res["peak"] / want["peak"]
        mean = {k: sum(st[k] for st in res["stats"]) / len(res["stats"]) for k in res["stats"][0]}
        lines.append(
            f"rank {r}: {', '.join(f'{t:.2f}' for t in res['ms'])} ms a request, peak "
            f"{res['peak'] / 2**30:.2f} GiB ({share:.3f} of one process), a request's collectives "
            f"{ {k: round(v, 2) for k, v in mean.items()} } (ms summed on the host clock), the query "
            f"request's {res['query_stats']}; fp32 check max |d| {check:.3g} px (bound {MODEL_CHECK_ATOL}); "
            f"bf16 |d| median / max / max(|d| - {SPATIAL_RTOL}|ref|): dense "
            f"{', '.join(f'{v:.3g}' for v in diffs['dense'])}, queries "
            f"{', '.join(f'{v:.3g}' for v in diffs['queries'])}; launches "
            f"{ {k: v for k, v in res['launches'].items() if v} }")
        if check > MODEL_CHECK_ATOL:
            fails.append(f"rank {r} fp32 check {check}")
        for key, (median, _, over) in diffs.items():
            if median >= SPATIAL_MEDIAN_PX or over > SPATIAL_ATOL:
                fails.append(f"rank {r} bf16 {key}: median {median}, |d| - rtol|ref| {over}")
        if share >= SPATIAL_PEAK_SHARE:
            fails.append(f"rank {r} peak {share:.3f} of one process's")
    if want["flipped_rows"] <= SPATIAL_MEDIAN_PX:
        fails.append(f"the planted row-flip fault's median {want['flipped_rows']} px does not exceed the bound "
                     f"{SPATIAL_MEDIAN_PX} px")
    launches = {name: want["launches"][name] + sum(r["launches"][name] for r in ranks) for name in want["launches"]}
    _keep("spatial", f"[spatial] IGEV ModelConfig(), bf16, {ITERS} iters, 1x{SPATIAL_H}x{SPATIAL_W} over "
          f"{SPATIAL_RANKS} ranks ({DDP_BACKEND}, one card), rows "
          f"{row_partition(SPATIAL_H, SPATIAL_RANKS)}, B1 {2 * ITERS} a request on every side (held request by "
          f"request): one process {', '.join(f'{t:.2f}' for t in want['ms'])} ms a request, peak "
          f"{want['peak'] / 2**30:.2f} GiB, launches { {k: v for k, v in want['launches'].items() if v} }, "
          f"|ref| median {float(want['dense'].abs().median()):.2f} px, its own median |d| in a batch of two "
          f"{want['floor']:.3g} px, through a one-rank spatial context (one_rank) {want['one_rank']:.3g} px and "
          f"on the row-flipped frame (flipped_rows, a planted fault) {want['flipped_rows']:.3g} px; median bound "
          f"{SPATIAL_MEDIAN_PX} px; "
          + "; ".join(lines) + f" ({wall:.1f} s for the ranks' processes in all); {card}")
    if fails:
        raise AssertionError("spatial inference against one process: " + "; ".join(fails))
    return launches


# ----------------------------------------------------------------- phase 13

# the JAX gate's recipe for the end-to-end demo (tests/test_train_gate.py)
TOOLS_E2E = ("--steps", "150", "--lr", "2e-4", "--epe-target", "2.1")
TOOLS_E2E_ITERS, TOOLS_E2E_VAL_FRAMES, TOOLS_E2E_VAL_ITERS = 4, 4, 8
TOOLS_OVERFIT_STEPS = 400
TOOLS_SMOKE_FRAMES, TOOLS_SMOKE_ITERS = 4, 4  # check_datasets' eval smoke: the SceneFlow TEST pairs
TOOLS_REHEARSAL_STEPS, TOOLS_REHEARSAL_FRAMES = 20, 2
TOOLS_REHEARSAL_VAL_ITERS = 32  # reproduce_baseline's --valid-iters


def _tool_main(name, argv):
    """`anystereo_tpu_torch.tools.<name>.main(argv)` in this process, its
    standard output captured, echoed and kept in OUT_DIR/tools_<name>.txt;
    (rc, output, seconds)."""
    import importlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = importlib.import_module(f"anystereo_tpu_torch.tools.{name}").main(list(argv))
    seconds = time.perf_counter() - t0
    text = buf.getvalue()
    _log(text.rstrip())
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"tools_{name}.txt"), "w") as f:
        f.write(text)
    return rc, text, seconds


def _tools_launches(kernels, steps, iters, frames, frame_iters):
    """The launches of `steps` IGEV training steps at `iters` iterations
    ("aligned": B1 2 + 2, gather 3, scatter 3 an iteration) and `frames`
    dense validation frames at `frame_iters` (B1 2 an iteration), nothing
    else."""
    return {**dict.fromkeys((k.__name__ for k in kernels), 0),
            "gather_pyramid_aligned": 2 * iters * steps + 2 * frame_iters * frames,
            "gather_pyramid_aligned_bwd": 2 * iters * steps, "gather_rows": 3 * iters * steps,
            "scatter_rows_add": 3 * iters * steps}


def phase_tools(torch, kernels, card, root):
    """The port's tools as a user runs them (`python -m
    anystereo_tpu_torch.tools.<name>`, here each `main` in this process):
    `make_synthetic_datasets` writes every tree at seed 0 (its nine
    protocols must resolve); `check_datasets --smoke` on it must exit 0 (its
    20-step train smoke is a CLI subprocess); `e2e_demo` at the JAX gate's
    recipe (150 steps at lr 2e-4, deterministic, fp32 without TF32) must
    print E2E PASS (held-out EPE under 2.1 px), and the same EPE alone in a
    process of its own; `overfit_sanity` at its 400 steps must
    print LEARNED;
    `reproduce_baseline` rehearses the 100k-step recipe for 20 steps and
    must write a row for each of the nine protocols (2 frames each) naming
    the card; `scaling_bench --devices 1` prints its line (its rank is a
    process of its own).  Launches in this process exact, stage by stage
    (B8 none: the SceneFlow tree holds the left view's PFMs only, so the
    left-right occlusion provider has nothing to warp)."""
    import re

    from anystereo_tpu_torch.config import TrainConfig
    from anystereo_tpu_torch.tools.make_synthetic_datasets import PROTOCOLS

    t_phase = time.perf_counter()
    tree, lines, seconds = os.path.join(root, "tools_tree"), [], {}
    launches = dict.fromkeys((k.__name__ for k in kernels), 0)

    def stage(name, argv, want=None, per_step=None):
        """Run one tool; hold its launches to `want` (and each training
        step's to `per_step`); its output and the ms of its steps."""
        before = _counts(kernels)
        log = {"steps": []}
        with _recorded_steps(torch, kernels, per_step, log, name) if per_step else contextlib.nullcontext():
            rc, text, seconds[name] = _tool_main(name, argv)
        if rc != 0:
            raise AssertionError(f"{name} {' '.join(argv)} exited {rc}: {text[-3000:]}")
        if want is not None:
            _expect_launches(kernels, before, want, name)
            for k, v in want.items():
                launches[k] += v
        return text, [ms for _, ms, _ in log["steps"]]

    def mean(ms):
        return f"first {ms[0]:.2f}, then mean {sum(ms[1:]) / len(ms[1:]):.2f}"

    text, _ = stage("make_synthetic_datasets", ["--out", tree, "--seed", "0", "--device", DEVICE])
    counts = {k: int(v) for k, v in re.findall(r"^(\w+) +(\d+) images$", text, re.M)}
    if sorted(counts) != sorted(PROTOCOLS) or min(counts.values()) < 1:
        raise AssertionError(f"make_synthetic_datasets resolved {counts}")
    lines.append(f"trees {counts} in {seconds['make_synthetic_datasets']:.1f} s")

    text, _ = stage("check_datasets", ["--data-root", tree, "--smoke", "--device", DEVICE],
                    _tools_launches(kernels, 0, 0, TOOLS_SMOKE_FRAMES, TOOLS_SMOKE_ITERS))
    if "eval smoke OK" not in text or "train smoke rc=0" not in text or text.count("[ok     ]") != 10:
        raise AssertionError(f"check_datasets --smoke: {text[-3000:]}")
    lines.append(f"check_datasets --smoke exit 0 (eval smoke {TOOLS_SMOKE_FRAMES} frames, CLI train smoke 20 "
                 f"steps) in {seconds['check_datasets']:.1f} s")

    steps = int(TOOLS_E2E[1])
    text, ms = stage("e2e_demo", ["--out", os.path.join(root, "tools_e2e"), *TOOLS_E2E, "--device", DEVICE],
                     _tools_launches(kernels, steps, TOOLS_E2E_ITERS, TOOLS_E2E_VAL_FRAMES, TOOLS_E2E_VAL_ITERS),
                     _tools_launches(kernels, 1, TOOLS_E2E_ITERS, 0, 0))
    found = re.search(r"^E2E (PASS|WEAK) epe=(\S+)$", text, re.M)
    if not found or found.group(1) != "PASS" or len(ms) != steps:
        raise AssertionError(f"e2e_demo {' '.join(TOOLS_E2E)}: {text[-3000:]}")
    # the demo alone, in a process of its own at PyTorch's default precision:
    # it pins its own, so it must read the same EPE as here after the phases
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "anystereo_tpu_torch.tools.e2e_demo", "--out",
                           os.path.join(root, "tools_e2e_alone"), *TOOLS_E2E, "--device", DEVICE],
                          cwd=HERE, capture_output=True, text=True, timeout=600)
    alone = re.search(r"^E2E (PASS|WEAK) epe=(\S+)$", proc.stdout, re.M)
    if proc.returncode != 0 or not alone or alone.group(2) != found.group(2):
        raise AssertionError(f"e2e_demo alone (exit {proc.returncode}) against {found.group(2)} px in this "
                             f"process: {proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    lines.append(f"e2e_demo {' '.join(TOOLS_E2E)}: E2E PASS, held-out EPE {found.group(2)} px, the same alone in a "
                 f"process of its own ({time.perf_counter() - t0:.1f} s); ms a step (synchronised) {mean(ms)}, "
                 f"min {min(ms[1:]):.2f}, max {max(ms[1:]):.2f}; {seconds['e2e_demo']:.1f} s")

    text, _ = stage("overfit_sanity", ["--steps", str(TOOLS_OVERFIT_STEPS), "--device", DEVICE],
                    _tools_launches(kernels, TOOLS_OVERFIT_STEPS, TOOLS_E2E_ITERS, 0, 0))
    found = re.search(r"^(LEARNED|NOT_LEARNED) final epe (\S+)$", text, re.M)
    first = re.search(r"^step +0 +loss +\S+ +epe +(\S+)", text, re.M)
    if not found or found.group(1) != "LEARNED" or not first:
        raise AssertionError(f"overfit_sanity: {text[-3000:]}")
    per_step = seconds["overfit_sanity"] / TOOLS_OVERFIT_STEPS * 1e3
    lines.append(f"overfit_sanity {TOOLS_OVERFIT_STEPS} steps: LEARNED, EPE {first.group(1)} -> {found.group(2)} "
                 f"px; {seconds['overfit_sanity']:.1f} s ({per_step:.2f} ms a step, the loss read each step)")

    table = os.path.join(root, "tools_baseline.md")
    it = TrainConfig().train_iters
    text, ms = stage("reproduce_baseline",
                     ["--data-root", tree, "--ckpt", os.path.join(root, "tools_ckpt"), "--num-steps",
                      str(TOOLS_REHEARSAL_STEPS), "--max-images", str(TOOLS_REHEARSAL_FRAMES), "--out", table,
                      "--device", DEVICE],
                     _tools_launches(kernels, TOOLS_REHEARSAL_STEPS, it, len(PROTOCOLS) * TOOLS_REHEARSAL_FRAMES,
                                     TOOLS_REHEARSAL_VAL_ITERS),
                     _tools_launches(kernels, 1, it, 0, 0))
    with open(table) as f:
        rows = [r for r in f.read().splitlines() if r.startswith("| ") and "epe=" in r]
    hardware = {r.split(" | ")[2] for r in rows}
    if len(rows) != len(PROTOCOLS) or hardware != {card} or len(ms) != TOOLS_REHEARSAL_STEPS:
        raise AssertionError(f"reproduce_baseline wrote {len(rows)} rows, Hardware {hardware}: {text[-3000:]}")
    lines.append(f"reproduce_baseline rehearsal: {TOOLS_REHEARSAL_STEPS} steps of the recipe (ms a step "
                 f"{mean(ms)}), {len(rows)} rows naming the card; {seconds['reproduce_baseline']:.1f} s")

    text, _ = stage("scaling_bench", ["--devices", "1", "--device", DEVICE])
    found = re.search(r"^devices 1: .*efficiency +100\.0%$", text, re.M)
    if not found:
        raise AssertionError(f"scaling_bench --devices 1: {text[-3000:]}")
    lines.append(f"scaling_bench: {found.group(0).strip()}; {seconds['scaling_bench']:.1f} s")

    _keep("tools", f"[tools] {time.perf_counter() - t_phase:.1f} s in all: " + "; ".join(lines) + f"; {card}")
    return launches


# ----------------------------------------------------------------- phase 14


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


def _grad_diff(got, want, rtol=GRAD_CHECK_RTOL):
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
        if not delta <= rtol * norm + floor:
            bad.append((name, delta, norm))
    return worst, worst_name, bad


def _check_train(torch, kernels, core, flavor):
    """fp32 training loss and gradients through the kernels against the same
    with every kernel forced to its plain version (which launches nothing)."""
    through_kernels, plain = _fp32_train_runs(torch, core, flavor)
    want = _step_counts(kernels, core, flavor, CHECK_ITERS)
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


def _check_remat(torch, kernels):
    """fp32, the train phase's step (`TrainConfig()` on its batch): the IGEV
    training loss and every parameter's gradient with `ModelConfig(remat=True)`
    against the same without, both through the kernels from the same seed-0
    weights, each with its exact launches (`_step_counts`): the recomputed
    iterations must give the gradients of the stored ones."""
    from anystereo_tpu_torch.config import TrainConfig
    from anystereo_tpu_torch.nn.model import build_model
    from anystereo_tpu_torch.train.step import loss_and_metrics

    tcfg = TrainConfig()
    batch = _train_batch(torch, tcfg.batch_size, TRAIN_H, TRAIN_W, tcfg.sample_q, seed=4)
    runs = {}
    for remat in (False, True):
        model = build_model(_config("igev", compute_dtype="float32", remat=remat), device=DEVICE, seed=0)
        before = _counts(kernels)
        with _flavor("aligned"):
            loss, _ = loss_and_metrics(model, tcfg, batch)
            loss.backward()
        torch.cuda.synchronize()
        _expect_launches(kernels, before, _step_counts(kernels, "igev", "aligned", tcfg.train_iters, remat),
                         f"IGEV fp32 training step{' under remat' if remat else ''}")
        runs[remat] = float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}
        del model, loss
        torch.cuda.empty_cache()
    (p_loss, p_grads), (r_loss, r_grads) = runs[False], runs[True]
    worst, worst_name, bad = _grad_diff(r_grads, p_grads)
    rel = abs(r_loss - p_loss) / abs(p_loss)
    _log(f"[check] IGEV fp32 training step {tcfg.batch_size}x{TRAIN_H}x{TRAIN_W}, Q {tcfg.sample_q}, "
         f"{tcfg.train_iters} iters, remat vs not: loss {r_loss:.6f} vs {p_loss:.6f} (relative "
         f"{rel:.2e}, bound {LOSS_CHECK_RTOL}); worst ||dg||/||g|| {worst:.2e} ({worst_name}) over "
         f"{len(p_grads)} parameters (bound {GRAD_CHECK_RTOL})")
    if not rel <= LOSS_CHECK_RTOL or bad:
        raise AssertionError(f"training with and without remat disagree: loss {r_loss} vs {p_loss}; {bad}")


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


def _fp32_deterministic(torch):
    """fp32 without TF32, cuDNN held to its deterministic algorithms."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def phase_check(torch, kernels):
    """fp32 without TF32, and cuDNN held to its deterministic algorithms: its
    other backward algorithms sum with atomics, and two runs of one and the
    same path then differ by up to 1e-2 relative in the cost aggregation's
    gradients (measured on the H100), which would hide the kernels' 5e-6."""
    _fp32_deterministic(torch)
    for core in ("igev", "raft"):
        _check_eval(torch, kernels, core)
        torch.cuda.empty_cache()
    _check_occlusion(torch)
    for core, flavor in (("igev", "aligned"), ("igev", "levels"), ("raft", "classify")):
        _check_train(torch, kernels, core, flavor)
        torch.cuda.empty_cache()
    _check_remat(torch, kernels)
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

    from anystereo_tpu_torch.ops.kernels.lookup import gather_pyramid_aligned

    parts = {"b1_fwd_ms": ("pyr_aligned_fwd", gather_pyramid_aligned)}
    prof_wall, kernel_ms, kernel_n, table, sums = _profiled(torch, forward, parts)
    summary = {"stages_ms": totals, "stages_wall_ms": wall, "forward_wall_ms": prof_wall,
               "kernel_ms": kernel_ms, "kernel_launches": kernel_n,
               "busy_share": kernel_ms / prof_wall, **sums}
    if PARENT:
        summary["in_turns"] = _in_turns(torch, forward, parts)
    IN_PATH["eval forward"] = {k: summary[k] for k in (*parts, "in_turns") if k in summary}
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "profile_forward.txt")
    with open(path, "w") as f:
        f.write(json.dumps(summary) + "\n" + table)
    _log(f"[profile] {json.dumps(summary)}; kernel table in {path}")
    _log(table)


# flavor -> (key, a part of the kernel's name, the wrapper's name)
LOOKUP_PARTS = {"classify": ("b4_fwd_ms", "window_pm_fwd", "gather_pyramid_window_pm"),
                "levels": ("b7_fwd_ms", "window_linear_fwd", "gather_window_linear")}


def phase_profile_lookup(torch, kernels, model, core, flavor):
    """--profile: one bf16 eval forward of `model` at full width under the
    lookup flavor `flavor` through torch.profiler, after a warm-up, with its
    launches checked; the flavor's lookup kernel (`LOOKUP_PARTS`) summed
    inside it and, with --parent, in turns with the parent's kernel."""
    key, part, name = LOOKUP_PARTS[flavor]
    parts = {key: (part, next(k for k in kernels if k.__name__ == name))}
    left, right = _images(torch, 1)
    want = dict.fromkeys((k.__name__ for k in kernels), 0)
    want.update(_lookup_counts(core, flavor, ITERS))

    def forward():
        return model(left, right, iters=ITERS)

    with _flavor(flavor):
        forward()
        before = _counts(kernels)
        wall, kernel_ms, kernel_n, table, sums = _profiled(torch, forward, parts)
        _expect_launches(kernels, before, want, f"the profiled {core} eval forward ({flavor})")
        summary = {"forward_wall_ms": wall, "kernel_ms": kernel_ms, "kernel_launches": kernel_n,
                   "busy_share": kernel_ms / wall, **sums}
        if PARENT:
            summary["in_turns"] = _in_turns(torch, forward, parts)
    IN_PATH[f"{core.upper()} eval forward ({flavor})"] = {
        k: summary[k] for k in (key, "in_turns") if k in summary}
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"profile_{core}_{flavor}.txt")
    with open(path, "w") as f:
        f.write(json.dumps(summary) + "\n" + table)
    _log(f"[profile] {core.upper()} eval forward ({flavor}): {json.dumps(summary)}; kernel table in {path}")


def _profiled(torch, fn, parts=None):
    """Run `fn` under torch.profiler: (wall ms, summed kernel ms, kernel
    launches, the table of kernels by device time, {key: ms}).  `parts` maps
    a key to (a part of a kernel's name, the wrapper that launches it): the
    key's ms sums the kernels whose names hold the part, and their count
    must equal the wrapper's launches in the run, so that a renamed, missed
    or added kernel fails the run instead of changing the sum."""
    parts = parts or {}
    before = {key: wrapper.launches for key, (_, wrapper) in parts.items()}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    kernel_us, kernel_n, named = 0.0, 0, {}  # kernel name -> [ms, count]
    for ev in averages:
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        if us > 0:
            kernel_us, kernel_n = kernel_us + us, kernel_n + ev.count
            ms_n = named.setdefault(ev.key, [0.0, 0])
            ms_n[0], ms_n[1] = ms_n[0] + us / 1e3, ms_n[1] + ev.count
    sums = {}
    for key, (part, wrapper) in parts.items():
        hits = [ms_n for name, ms_n in named.items() if part in name]
        found, launched = sum(n for _, n in hits), wrapper.launches - before[key]
        if found != launched or launched == 0:
            raise AssertionError(f"{key}: {found} profiled kernels hold {part!r}, but "
                                 f"{wrapper.__name__} launched {launched}")
        sums[key] = sum(ms for ms, _ in hits)
    return wall, kernel_us / 1e3, kernel_n, averages.table(sort_by="cuda_time_total", row_limit=40), sums


def _in_turns(torch, fn, parts):
    """{key: {"this": [ms, ms], "parent": [ms, ms]}}: the kernels of
    `parts[key]` (as `_profiled` takes them, their count checked against the
    wrapper's launches), summed over one run of `fn` under torch.profiler, in
    turns this tree, parent, parent, this tree, with the parent's C entry
    points swapped into the wrappers (whose counts go on): each kernel inside
    the path, with L2 as the path's other kernels leave it."""
    turns = {key: {"this": [], "parent": []} for key in parts}
    for who in ("this", "parent", "parent", "this"):
        sums = _profiled(torch, _as_parent(fn) if who == "parent" else fn, parts)[4]
        for key in parts:
            turns[key][who].append(sums[key])
    return turns


def _beside_parent_line(records):
    """One short line of the times (ms) that --parent and --profile add, so
    that they stay in a log that keeps only the end of the output."""
    def r(v):
        if isinstance(v, dict):
            return {k: r(t) for k, t in v.items()}
        return [round(t, 5) for t in v] if isinstance(v, list) else round(v, 5)

    common = ("ms", "ms_beside_parent", "parent_ms", "floor_ms", "plain_ms", "bound_ms")
    clean = ("ms_clean", "floor_ms_clean")
    path = ("ms_path", "ms_path_beside_parent", "parent_ms_path", "bound_ms_path")
    library = ("ms", "library_ms", "library_err", "library_bwd_err", "gather_body_ms", "bound_ms")
    keys = {"gather_pyramid_aligned": ("B1", lambda c: c["call"], common + path + ("copy_ms",)),
            "gather_pyramid_aligned_bwd": ("B1 bwd", lambda c: c["call"], common + clean + ("accumulate_ms",)),
            "scatter_rows_add": ("B2", lambda c: f"C={c['table'][2]}", common + (
                "library_ms", "deterministic_ms", "parent_deterministic_ms", "deterministic_ms_beside_parent",
                "deterministic_library_ms")),
            "gather_rows": ("B3", lambda c: f"C={c['table'][2]}", common + clean + ("library_ms",)),
            "gather_pyramid_window_pm": ("B4", lambda c: c["call"], common + path + ("ms_clean",)),
            "gather_pyramid_window_pm_bwd": ("B4 bwd", lambda c: c["call"], common + path + ("ms_clean",)),
            "gather_pyramid_window_t": ("B5", lambda c: c["call"], common + path + ("ms_clean",)),
            "gather_pyramid_window": ("B6", lambda c: c["call"], common + path + (
                "ms_clean", "bound_ms_sectors", "bound_ms_path_sectors", "copy_ms", "copy_ms_clean")),
            "gather_pyramid_window_bwd": ("B6 bwd", lambda c: c["call"], common + path + ("ms_clean",)),
            "gather_window_linear": ("B7", lambda c: c["call"], common + path + (
                "ms_clean", "library_ms", "library_err")),
            "gather_window_linear_bwd": ("B7 bwd", lambda c: c["call"], common + clean + library),
            "gather_rows_linear": ("B8", lambda c: c["call"], common + clean + library),
            "gather_rows_linear_bwd": ("B8 bwd", lambda c: c["call"], common + clean + library)}
    out = {"launch": r(YARDSTICK)}
    for rec in records:
        if rec["name"] in keys:
            tag, call, wanted = keys[rec["name"]]
            for c in rec["per_call"]:
                out[f"{tag} {call(c)}"] = {k: r(c[k]) for k in wanted if k in c}
    for path, times in IN_PATH.items():
        out[f"in the {path}"] = r(times)
    return "[beside parent] " + json.dumps(out, separators=(",", ":"))


def _train_parts(flavor):
    """{key: (a part of a kernel's name, its wrapper)} of the kernels that
    `phase_profile_train` sums inside a training step under `flavor`:
    "aligned": B1 forward (32 launches a step) and backward (32), B2 (48),
    B3 (48); "levels": B7 forward (64) and backward (64); "classify" (the
    RAFT step): B4 forward (16) and backward (16)."""
    from anystereo_tpu_torch.ops.kernels import lookup_linear as tl
    from anystereo_tpu_torch.ops.kernels import lookup_window as tw
    from anystereo_tpu_torch.ops.kernels.gather import gather_rows, scatter_rows_add
    from anystereo_tpu_torch.ops.kernels.lookup import (
        gather_pyramid_aligned,
        gather_pyramid_aligned_bwd,
    )

    if flavor == "classify":
        return {"b4_fwd_ms": ("window_pm_fwd", tw.gather_pyramid_window_pm),
                "b4_bwd_ms": ("window_t_bwd", tw.gather_pyramid_window_pm_bwd)}
    if flavor == "levels":
        return {"b7_fwd_ms": ("window_linear_fwd", tl.gather_window_linear),
                "b7_bwd_ms": ("window_linear_bwd", tl.gather_window_linear_bwd)}
    return {"b1_fwd_ms": ("pyr_aligned_fwd", gather_pyramid_aligned),
            "b1_bwd_ms": ("pyr_aligned_bwd", gather_pyramid_aligned_bwd),
            "b2_ms": ("scatter_rows_add", scatter_rows_add), "b3_ms": ("gather_rows_fwd", gather_rows)}


def phase_profile_train(torch, model, tcfg, state, step, batch, flavor="aligned", remat=False):
    """Stream time of the forward, the backward and the optimizer of one
    training step (CUDA events) under the lookup flavor `flavor` (`remat`:
    the model was built with it), then the whole step under torch.profiler
    with the kernels of `_train_parts` summed inside it (with --parent in
    turns with the parent's)."""
    from anystereo_tpu_torch.train.step import loss_and_metrics

    def ev():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    parts = _train_parts(flavor)
    with _flavor(flavor):
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
        prof_wall, kernel_ms, kernel_n, table, sums = _profiled(torch, lambda: step(state, batch), parts)
        turns = _in_turns(torch, lambda: step(state, batch), parts) if PARENT else None
    stages = {"forward": e0.elapsed_time(e1), "backward": e1.elapsed_time(e2),
              "optimizer": e2.elapsed_time(e3)}
    summary = {"stages_ms": stages, "stages_wall_ms": wall, "step_wall_ms": prof_wall,
               "kernel_ms": kernel_ms, "kernel_launches": kernel_n,
               "busy_share": kernel_ms / prof_wall, **sums}
    if turns is not None:
        summary["in_turns"] = turns
    tag = "_".join(([] if flavor == "aligned" else [flavor]) + (["remat"] if remat else []))
    label = "training step" + (f" ({tag.replace('_', ', ')})" if tag else "")
    IN_PATH[label] = {k: summary[k] for k in (*parts, "in_turns") if k in summary}
    os.makedirs(OUT_DIR, exist_ok=True)
    name = f"profile_train_{tag}.txt" if tag else "profile_train.txt"
    path = os.path.join(OUT_DIR, name)
    with open(path, "w") as f:
        f.write(json.dumps(summary) + "\n" + table)
    _log(f"[profile] {label}: {json.dumps(summary)}; kernel table in {path}")
    _log(table)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 2
    kernels = _launch_counters()
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
    classify, model = phase_model(torch, kernels, "raft", "classify", keep=profile)
    by_path["eval_raft"] = {k: v + classify[k] for k, v in by_path["eval_raft"].items()}
    if profile:
        phase_profile_lookup(torch, kernels, model, "raft", "classify")
        del model
        from anystereo_tpu_torch.nn.model import build_model

        model = build_model(_config("igev"), device=DEVICE, seed=0)
        phase_profile_lookup(torch, kernels, model, "igev", "classify")
        del model
    torch.cuda.empty_cache()
    by_path["eval_levels"], model = phase_model(torch, kernels, "igev", "levels", keep=profile)
    if profile:
        phase_profile_lookup(torch, kernels, model, "igev", "levels")
    del model
    torch.cuda.empty_cache()
    raft_levels, _ = phase_model(torch, kernels, "raft", "levels")
    by_path["eval_levels"] = {k: v + raft_levels[k] for k, v in by_path["eval_levels"].items()}
    torch.cuda.empty_cache()
    _log("[model] ms per pair by lookup flavor: " + "; ".join(
        f"{core.upper()} " + ", ".join(f"{fl} {ms:.2f}" for (c, fl), ms in PAIR_MS.items() if c == core)
        for core in ("igev", "raft")))
    by_path["bench"] = phase_bench(torch, kernels, card)
    torch.cuda.empty_cache()
    by_path["validate"] = phase_validate(torch, kernels)
    torch.cuda.empty_cache()
    by_path["train_igev"], trained = phase_train(torch, kernels, "igev", "aligned")
    if profile:
        phase_profile_train(torch, *trained)
    del trained
    torch.cuda.empty_cache()
    by_path["train_remat"], trained = phase_train(torch, kernels, "igev", "aligned", remat=True)
    if profile:
        phase_profile_train(torch, *trained, remat=True)
    del trained
    torch.cuda.empty_cache()
    (ms, peak), (remat_ms, remat_peak) = (STEP_MS[("igev", "aligned", r)] for r in (False, True))
    _log(f"[train] IGEV training step under remat: {remat_ms:.2f} ms/step, peak {remat_peak:.2f} GiB; "
         f"without: {ms:.2f} ms/step, peak {peak:.2f} GiB ({remat_ms / ms:.3f}x the time, "
         f"{remat_peak / peak:.3f}x the memory)")
    by_path["train_raft"], trained = phase_train(torch, kernels, "raft", "classify")
    if profile:
        phase_profile_train(torch, *trained, flavor="classify")
    del trained
    torch.cuda.empty_cache()
    by_path["train_levels"], trained = phase_train(torch, kernels, "igev", "levels", steps=1)
    if profile:
        phase_profile_train(torch, *trained, flavor="levels")
    del trained
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        by_path["trainer"], sf, kitti, ft = phase_trainer(torch, kernels, card, root)
        torch.cuda.empty_cache()
        by_path["loader"] = phase_loader(torch, kernels, card, root, sf, ft)
        torch.cuda.empty_cache()
        by_path["convert"], converted = phase_convert(torch, kernels, card, root, kitti)
        torch.cuda.empty_cache()
        by_path["cli"] = phase_cli(torch, kernels, card, root, sf, kitti, converted)
        torch.cuda.empty_cache()
        by_path["ddp"] = phase_ddp(torch, kernels, card, root)
        torch.cuda.empty_cache()
        by_path["spatial"] = phase_spatial(torch, kernels, card, root)
        torch.cuda.empty_cache()
        by_path["tools"] = phase_tools(torch, kernels, card, root)
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
    line = json.dumps({"kernels": records})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "kernels.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    if PARENT:
        _log(_beside_parent_line(records))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
