"""Reproduce the reference's training recipe with the port and write the
rows of a baseline table.

The reference publishes no benchmark numbers (SURVEY.md §6), so the
acceptance protocol is self-generated: run the reference's pinned 100k-step
recipe (train_continuous_IGEV.py:125-134,291-301: AdamW lr 2e-4 wd 1e-5,
OneCycle, batch 2, 16 train / 32 valid iters, grad-clip 1.0, max_disp 192)
on SceneFlow, then evaluate every dataset protocol the reference defines
(evaluation_validate.py:121-533) and write the metric table, one row a
protocol, its Hardware column the card's name and power limit as
`nvidia-smi` prints them (or `cpu`).  The port's counterpart of the repo's
`tools/reproduce_baseline.py`.

Stages (each skippable so partial runs resume):

  python -m anystereo_tpu_torch.tools.reproduce_baseline --data-root /datasets \\
      [--ckpt ckpts/ref-repro]        # train if the ckpt dir holds no step
      [--skip-train]                  # eval-only from an existing ckpt
      [--datasets sceneflow kitti15]  # subset of eval protocols
      [--out BASELINE_measured.md] [--device cpu]

A checkpoint is `<ckpt>/<step>/checkpoint.pt` (`train/state.py`); training
resumes from the latest one.
"""

from __future__ import annotations

import argparse
import sys

EVAL_PROTOCOLS = [
    # (name, dataset key, scale_test, note)
    ("SceneFlow EPE (finalpass TEST, seed-1000 subset)", "sceneflow", 1.0, ""),
    ("KITTI-2015 D1-all", "kitti15", 1.0, "occ/noc from disp_occ vs disp_noc"),
    ("KITTI-2012 D1-all", "kitti12", 1.0, ""),
    ("ETH3D EPE/D1", "eth3d", 1.0, "occ/noc from mask0nocc.png"),
    ("Middlebury Q EPE/D1", "middlebury_Q", 1.0, ""),
    ("Middlebury H EPE/D1", "middlebury_H", 1.0, ""),
    ("Middlebury F EPE/D1", "middlebury_F", 1.0,
     "full res; spatial tiling via python -m anystereo_tpu_torch.tools.tiled_infer if OOM"),
    ("Middlebury Q->F (x4 arbitrary-scale)", "middlebury_Q_F", 1.0, "fixed-upscale protocol evaluation_validate.py:430-436"),
    ("Middlebury H->F (x2 arbitrary-scale)", "middlebury_H_F", 1.0, "fixed-upscale protocol evaluation_validate.py:453-462"),
]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-root", required=True,
                   help="directory containing sceneflow/, kitti15/, ... trees")
    p.add_argument("--ckpt", default="ckpts/ref-repro")
    p.add_argument("--skip-train", action="store_true")
    p.add_argument("--num-steps", type=int, default=100_000)
    p.add_argument("--datasets", nargs="+", default=None,
                   help="subset of eval dataset keys (default: all available)")
    p.add_argument("--valid-iters", type=int, default=32)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--out", default="BASELINE_measured.md")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from anystereo_tpu_torch.config import Config, ModelConfig, TrainConfig
    from anystereo_tpu_torch.train.state import checkpoint_steps
    from anystereo_tpu_torch.utils.device import describe_device, resolve_device

    device = resolve_device(args.device)
    hardware = describe_device(device)
    model_cfg = ModelConfig(max_disp=192, corr_levels=2, corr_radius=4)

    # ---- stage 1: train the reference recipe (resumable) ---------------
    have_ckpt = bool(checkpoint_steps(args.ckpt))
    if not args.skip_train and not have_ckpt:
        from anystereo_tpu_torch.data.augment import AugmentorConfig
        from anystereo_tpu_torch.data.datasets import fetch_dataset
        from anystereo_tpu_torch.data.loader import PrefetchLoader
        from anystereo_tpu_torch.train.trainer import train

        cfg = Config(
            model=model_cfg,
            train=TrainConfig(
                lr=2e-4,
                num_steps=args.num_steps,
                batch_size=2,
                train_iters=16,
                multi_scale=True,
                inp_size=(160, 320),
                scale_min=1.0,
                scale_max=2.95,
                supervise_init=True,
                ckpt_dir=args.ckpt,
            ),
        )
        roots = {k: args.data_root for k in ("sceneflow",)}
        dataset = fetch_dataset(
            ["sceneflow"], roots,
            AugmentorConfig(crop_size=(160, 320), yjitter=True),
            multi_scale=True, scale_min=1.0, scale_max=2.95,
            inp_size=(160, 320),
        )
        loader = PrefetchLoader(dataset, 2, num_workers=8, seed=cfg.train.seed)
        print(f"training reference recipe: {args.num_steps} steps "
              f"-> {args.ckpt}", flush=True)
        train(cfg, loader, device=device)
    else:
        print(f"skipping training (ckpt {'found' if have_ckpt else 'skipped'})")

    # ---- stage 2: run every eval protocol and collect rows -------------
    from anystereo_tpu_torch.eval.validate import build_eval_dataset, run_validation

    rows = []
    for title, key, scale_test, note in EVAL_PROTOCOLS:
        if args.datasets and key not in args.datasets:
            continue
        try:
            ds, *_ = build_eval_dataset(key, args.data_root, device)
            if len(ds) == 0:
                print(f"[skip] {key}: no images under {args.data_root}", flush=True)
                continue
        except (FileNotFoundError, AssertionError) as e:
            print(f"[skip] {key}: {e}", flush=True)
            continue
        try:
            res = run_validation(
                model_cfg=model_cfg,
                ckpt_dir=args.ckpt,
                dataset=key,
                data_root=args.data_root,
                valid_iters=args.valid_iters,
                scale_test=scale_test,
                max_images=args.max_images,
                device=device,
            )
        except FileNotFoundError as e:
            print(f"[skip] {key}: dataset not found ({e})", flush=True)
            continue
        except Exception as e:  # noqa: BLE001 - keep going; report what failed
            print(f"[FAIL] {key}: {type(e).__name__}: {e}", flush=True)
            continue
        val = ", ".join(f"{k}={v:.4f}" for k, v in sorted(res.items()))
        rows.append(f"| {title} | {val} | {hardware} | {note} |")
        print(rows[-1], flush=True)

    # ---- stage 3: write the table ---------------------------------------
    if rows:
        with open(args.out, "w") as f:
            f.write("# Measured reference-recipe results (generated by "
                    "python -m anystereo_tpu_torch.tools.reproduce_baseline)\n\n")
            f.write("| Metric | Value | Hardware | Notes |\n|---|---|---|---|\n")
            f.write("\n".join(rows) + "\n")
        print(f"wrote {len(rows)} rows to {args.out} — paste into BASELINE.md")
    else:
        print("no datasets evaluated (none mounted?)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
