"""End-to-end demo and smoke of the port: every subsystem in one run.

Writes a small synthetic stereo dataset (PNG images and PFM ground truth
with a spatially varying disparity), trains the IGEV model through the real
pipeline (`StereoDataset` multi-scale sampling, the augmentor,
`PrefetchLoader`, `train()` with a checkpoint), then validates the held-out
pairs through `validate_dataset` (padding, dense decode, metrics, a report
with images) and prints the EPE.  The run uses PyTorch's deterministic
algorithms and full fp32 (no TF32), so that it repeats from its seed on the
card as on the CPU, whatever precision its caller had set.  The port's
counterpart of the repo's `tools/e2e_demo.py`, with its flags, recipe and
exit codes (0 PASS, 1 WEAK, 2 a non-finite EPE); the pairs come from
`make_synthetic_datasets`'s numpy redo of OpenCV's blur and remap, not from
OpenCV.

  python -m anystereo_tpu_torch.tools.e2e_demo --steps 150 --lr 2e-4 \\
      --epe-target 2.1 [--out DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import tempfile

import numpy as np

from anystereo_tpu_torch.tools.make_synthetic_datasets import gaussian_blur, remap_x


def make_dataset(root: str, n: int, h: int = 96, w: int = 192, seed: int = 0):
    """Synthetic textured stereo pairs: right = warp(left) by a smooth
    disparity field; GT written as PFM."""
    from anystereo_tpu_torch.data.frame_utils import write_pfm
    from anystereo_tpu_torch.data.png import write_png

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    margin = 24
    for i in range(n):
        tex = gaussian_blur(rng.rand(h, w + margin, 3).astype(np.float32), 1.2)
        tex = (tex - tex.min()) / (tex.max() - tex.min()) * 255
        # smooth disparity field in [4, 14] px
        dgrid = gaussian_blur(rng.rand(h, w).astype(np.float32), 12)
        dgrid = 4 + 10 * (dgrid - dgrid.min()) / max(float(np.ptp(dgrid)), 1e-6)
        left = tex[:, margin:]
        xs = np.arange(w)[None, :] + margin - dgrid
        right = np.stack([remap_x(tex[..., c], xs.astype(np.float32)) for c in range(3)], axis=-1)
        write_png(f"{root}/l{i:03d}.png", left.astype(np.uint8))
        write_png(f"{root}/r{i:03d}.png", right.astype(np.uint8))
        write_pfm(f"{root}/d{i:03d}.pfm", dgrid.astype(np.float32))


def build(root, n, multi_scale, inp_size):
    from anystereo_tpu_torch.data.augment import AugmentorConfig
    from anystereo_tpu_torch.data.datasets import StereoDataset

    ds = StereoDataset(
        aug=AugmentorConfig(
            crop_size=inp_size, min_scale=-0.1, max_scale=0.2, yjitter=False,
            eraser_prob=0.2,
        ),
        multi_scale=multi_scale,
        scale_min=1.0,
        scale_max=1.6,
        inp_size=inp_size,
    )
    for i in range(n):
        ds.image_list.append([f"{root}/l{i:03d}.png", f"{root}/r{i:03d}.png"])
        ds.disparity_list.append(f"{root}/d{i:03d}.pfm")
    return ds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "anystereo_e2e"))
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--pairs", type=int, default=16)
    ap.add_argument("--epe-target", type=float, default=2.0,
                    help="held-out EPE the run must beat to PASS")
    ap.add_argument("--lr", type=float, default=4e-4,
                    help="peak OneCycle LR (the reference trains at 2e-4; "
                         "4e-4 converges faster on the short demo runs)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    # the trainer reports through `logging` — make its progress visible on
    # the console so long runs are observable
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s"
    )

    import torch

    # The gate is a seeded band, so the run must repeat from its seed: on the
    # card the scatter-add's atomics and cuDNN's fastest backward algorithms
    # sum in an order that changes from run to run, and 150 steps carry that
    # rounding to a different held-out EPE; so does TF32, which PyTorch
    # leaves on for cuDNN's convolutions by default.  PyTorch's
    # deterministic algorithms for the run (the scatter-add's ordered kernel
    # among them) and full fp32 (TF32 off in cuDNN and in cuBLAS's matmuls,
    # the arithmetic of a CPU run); the caller's settings back after it.
    backends = torch.backends
    was = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
           backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = False
    try:
        return _run(args)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32 = was[2:]


def _run(args) -> int:
    from anystereo_tpu_torch.config import Config, ModelConfig, TrainConfig
    from anystereo_tpu_torch.data.loader import PrefetchLoader
    from anystereo_tpu_torch.eval.validate import validate_dataset
    from anystereo_tpu_torch.train.trainer import train
    from anystereo_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    data_root = os.path.join(args.out, "data")
    make_dataset(data_root, args.pairs + 4)

    inp = (64, 128)
    train_ds = build(data_root, args.pairs, multi_scale=True, inp_size=inp)
    cfg = Config(
        model=ModelConfig(max_disp=64),
        train=TrainConfig(
            train_iters=4,
            batch_size=2,
            lr=args.lr,
            num_steps=args.steps,
            warmup_frac=0.05,
            ckpt_every=args.steps,
            ckpt_dir=os.path.join(args.out, "ckpt"),
            supervise_init=True,
            inp_size=inp,
            scale_min=1.0,
            scale_max=1.6,
        ),
    )
    loader = PrefetchLoader(train_ds, cfg.train.batch_size, num_workers=4, seed=0)
    state = train(cfg, loader, device=device)

    # held-out pairs through the full validator (pad + dense decode + metrics)
    val_ds = build(data_root, args.pairs + 4, multi_scale=False, inp_size=inp)
    val_ds.image_list = val_ds.image_list[args.pairs :]
    val_ds.disparity_list = val_ds.disparity_list[args.pairs :]
    val_ds.augmentor = None
    results = validate_dataset(
        state.model, val_ds, valid_iters=8,
        report_dir=os.path.join(args.out, "report"), dump_images=True, device=device,
    )
    print("held-out validation:", {k: round(v, 3) for k, v in results.items()})
    epe = results.get("epe", float("nan"))
    if not np.isfinite(epe):
        print(f"E2E FAIL epe={epe} — non-finite predictions (diverged?)")
        return 2
    ok = epe < args.epe_target
    print("E2E", "PASS" if ok else "WEAK", f"epe={epe:.3f}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
