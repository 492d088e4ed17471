"""Spatially tiled high-resolution inference (the port's counterpart of the
repo's `tools/tiled_infer.py`; BASELINE config #4, a Middlebury-F-class
frame).

Every rank of the process group holds a tile of the frame's rows and runs
the eval forward on it (`parallel/spatial.infer_spatial_sharded`: halo
exchanges for the convolutions, the whole image's statistics for the
normalisations).  It reports each rank's peak device memory against one
process's peak on the whole frame (the JAX tool reads XLA's memory
analysis; the port measures `torch.cuda.max_memory_allocated` around the
two forwards, each timed after a warm-up request), and with --execute
holds the fp32 tiled output to the one process's.

  torchrun --nproc-per-node 2 -m anystereo_tpu_torch.tools.tiled_infer \\
      --height 1504 --width 2016 [--iters 8] [--max-disp 192] [--execute] [--device cpu]

or one process a rank under COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID
(`parallel/mesh.maybe_initialize_distributed`): a rank a card over NCCL, or
ranks on the CPU (`--device cpu`) over gloo.  A caller that has initialised
a process group itself (say gloo, for ranks that share one card, which NCCL
refuses) keeps it.  The one-process forward runs on rank 0 while the other
ranks wait.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from anystereo_tpu_torch.config import ModelConfig
from anystereo_tpu_torch.nn.model import build_model
from anystereo_tpu_torch.parallel.mesh import maybe_initialize_distributed, rank_device
from anystereo_tpu_torch.parallel.spatial import gather_batch, infer_spatial_sharded, row_partition

TILED_ATOL = 1e-2  # px, fp32: the JAX tool's bound


def human(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024:
            return f"{n:.1f} {unit}"
        n /= 1024
    return f"{n:.1f} TiB"


def _peak(dev, fn):
    """fn()'s result after one warm-up call, its host ms, and the device
    memory it held at its peak (what was allocated before it included), or
    None on the CPU."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--height", type=int, default=1504)
    p.add_argument("--width", type=int, default=2016)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--max-disp", type=int, default=192)
    p.add_argument("--execute", action="store_true",
                   help="compute in fp32 (TF32 off, cuDNN deterministic) and hold the tiled output to the "
                   "one process's within 1e-2 px; under bf16 the softargmax over max_disp/4 bins amplifies "
                   "benign reduction-order noise")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    maybe_initialize_distributed(require=True, device=args.device)
    world, rank = dist.get_world_size(), dist.get_rank()
    dev = rank_device(args.device)
    h, w = args.height, args.width
    bounds = row_partition(h, world)
    cfg = ModelConfig(max_disp=args.max_disp, **({"compute_dtype": "float32"} if args.execute else {}))
    if args.execute and dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    try:
        model = build_model(cfg, dev, seed=0)
        rng = np.random.RandomState(0)
        left = torch.from_numpy((rng.rand(1, h, w, 3) * 255).astype(np.float32)).to(dev)
        right = torch.from_numpy((rng.rand(1, h, w, 3) * 255).astype(np.float32)).to(dev)
        if rank == 0:
            print(f"tiling {h}x{w} over {world} ranks ({dist.get_backend()}), rows {bounds}, "
                  f"{args.iters} iterations, {cfg.compute_dtype}", flush=True)
        tiled, tiled_ms, tiled_peak = _peak(dev, lambda: infer_spatial_sharded(
            model, None, left, right, None, None, None, iters=args.iters))
        if rank == 0:
            single, single_ms, single_peak = _peak(dev, lambda: model(left, right, iters=args.iters).disp_final)
        dist.barrier()
        peaks = gather_batch(torch.tensor([[-1.0 if tiled_peak is None else float(tiled_peak), tiled_ms]],
                                          dtype=torch.float64, device=dev), None).tolist()
        if rank == 0:
            for r, (peak, ms) in enumerate(peaks):
                mem = "not measured on the CPU" if peak < 0 else (
                    f"peak {human(peak)} = {peak / single_peak:.2f}x of one process "
                    f"(ideal {1 / world:.3f}x + halo/replicated-weight overhead)")
                print(f"rank {r} (rows {bounds[r]}-{bounds[r + 1]}): {ms:.1f} ms, {mem}")
            mem = "not measured on the CPU" if single_peak is None else f"peak {human(single_peak)}"
            print(f"one process: {single_ms:.1f} ms, {mem}")
            if args.execute:
                err = float((tiled - single).abs().max())
                print(f"max |tiled - one process| = {err:.2e} px (fp32 compute)")
                if not err < TILED_ATOL:
                    print("tiled inference diverges from one process", file=sys.stderr)
                    return 1
                print("outputs agree")
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
