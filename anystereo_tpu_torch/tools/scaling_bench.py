"""Scaling efficiency of data-parallel training: samples/s/device of the
training step at 1, 2, 4 ... ranks, and the efficiency against one.

The port's counterpart of the repo's `tools/scaling_bench.py`, at its shape
(`ModelConfig(max_disp=64)`, 64x128, 2,048 queries, one sample a rank,
`supervise_init`).  `make_train_step` sums the gradients over the whole
process group, so each size runs as a group of its own: the tool spawns n
ranks for each n in --devices (one card a rank over NCCL; with
`--device cpu`, ranks on the CPU over gloo), each times `--steps` steps
after a warm-up step with the host synchronised on the loss every step, and
the slowest rank's ms per step is the size's.

  python -m anystereo_tpu_torch.tools.scaling_bench [--devices 1 2 4] [--steps 5] \\
      [--iters 4] [--device cpu]

A size larger than the cards present raises; nothing runs on fewer cards.
"""

from __future__ import annotations

import argparse
import os
import queue
import socket
import sys
import time

import numpy as np

H, W, Q = 64, 128, 2048


def batch_for(rng, b):
    return {
        "left": rng.rand(b, H, W, 3).astype(np.float32) * 255,
        "right": rng.rand(b, H, W, 3).astype(np.float32) * 255,
        "coords": (rng.rand(b, Q, 2).astype(np.float32) * 2 - 1) * 0.99,
        "gt": rng.rand(b, Q).astype(np.float32) * 20,
        "valid": np.ones((b, Q), np.float32),
        "scale": np.ones((b,), np.float32),
        "gt_low": rng.rand(b, H // 4, W // 4).astype(np.float32) * 5,
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank, world, port, device, batch, iters, steps, threads, results):
    """One rank of a size: train on sample `rank` of `batch`; puts (rank, s
    per step) on `results`.  On the CPU the ranks share the parent's
    `threads` intra-op threads."""
    import torch
    import torch.distributed as dist

    from anystereo_tpu_torch.config import ModelConfig, TrainConfig
    from anystereo_tpu_torch.data.loader import to_device
    from anystereo_tpu_torch.nn.model import build_model
    from anystereo_tpu_torch.parallel.mesh import maybe_initialize_distributed, rank_device
    from anystereo_tpu_torch.train.state import create_train_state
    from anystereo_tpu_torch.train.step import make_train_step

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, threads // world))
    if world > 1:
        maybe_initialize_distributed(require=True, device=device)
    try:
        dev = rank_device(device)
        model = build_model(ModelConfig(max_disp=64), dev, seed=0)
        tcfg = TrainConfig(train_iters=iters, batch_size=1, supervise_init=True)
        state = create_train_state(model, tcfg, dev)
        step = make_train_step(model, tcfg, device=dev)
        mine = to_device({k: v[rank:rank + 1] for k, v in batch.items()}, dev)
        state, m = step(state, mine)  # warm-up: cuDNN's choices, the kernels' first launches
        float(m["loss"])
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, mine)
            float(m["loss"])  # host sync
        results.put((rank, (time.perf_counter() - t0) / steps))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_size(n, device, batch, iters, steps) -> float:
    """Spawn the n ranks of one size; the slowest rank's s per step."""
    import torch
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    threads = torch.get_num_threads()
    procs = [ctx.Process(target=_rank, args=(r, n, port, device, batch, iters, steps, threads, results))
             for r in range(n)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < n:  # drain before joining
            try:
                rank, dt = results.get(timeout=5)
                got[rank] = dt
            except queue.Empty:
                failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"a rank of size {n} exited with {failed}")
        for p in procs:
            p.join(120)
        codes = [p.exitcode for p in procs]
        if codes != [0] * n:
            raise RuntimeError(f"the ranks of size {n} exited with {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return max(got.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (the default: a card a rank, NCCL) or cpu (gloo)")
    args = ap.parse_args(argv)

    import torch

    from anystereo_tpu_torch.utils.device import describe_device, resolve_device

    device = resolve_device(args.device)
    n_avail = torch.cuda.device_count() if device.type == "cuda" else (os.cpu_count() or 1)
    sizes = args.devices or [n for n in (1, 2, 4, 8) if n <= n_avail]
    too_many = [n for n in sizes if n > n_avail or n < 1]
    if too_many:
        raise ValueError(f"sizes {too_many}: {n_avail} {device.type} devices are present; "
                         "each rank needs one of its own")
    rng = np.random.RandomState(0)
    base_rate = None
    print(f"platform {device.type}  devices {n_avail}  ({describe_device(device)})", flush=True)
    for n in sizes:
        b = n  # one sample per device
        dt = _run_size(n, device.type, batch_for(rng, b), args.iters, args.steps)
        rate = b / dt
        per_dev = rate / n
        if base_rate is None:
            base_rate = per_dev
        eff = per_dev / base_rate
        print(
            f"devices {n}: {dt * 1000:8.1f} ms/step  {rate:7.2f} samples/s  "
            f"{per_dev:7.2f}/device  efficiency {eff * 100:5.1f}%", flush=True
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
