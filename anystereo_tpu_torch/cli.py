"""Command-line entry points of the port (the JAX package's
`anystereo_tpu/cli.py`, with the same flags, defaults and help, plus
`--device`):

  python -m anystereo_tpu_torch.cli train --core igev --datasets sceneflow \
      --data-root /datasets/sceneflow --multi-scale
  python -m anystereo_tpu_torch.cli evaluate --dataset kitti15 --data-root /datasets/kitti \
      --ckpt ckpts/
  python -m anystereo_tpu_torch.cli train ... --device cpu   # the CPU, by name
  python -m anystereo_tpu_torch.cli bench                    # one JSON line (`bench.py`)

All three run on the CUDA card unless `--device` names another; without a card
they raise.  `train --multihost` initialises the process group from the
cluster environment (`parallel/mesh.py`: the JAX package's
`COORDINATOR_ADDRESS` / `NUM_PROCESSES` / `PROCESS_ID`, or torchrun's) and
trains data-parallel over every rank, one card a rank:

  torchrun --nproc-per-node 2 -m anystereo_tpu_torch.cli train --multihost ...

`--loader grain` is refused: the grain loader is not ported.

Like the JAX CLI, `train` and `evaluate` build the GroupNorm model
(`_model_cfg`), never `config.reference_regime_config`'s frozen BatchNorm:
a converted reference checkpoint's norm tensors find no home there and are
not loaded (`restore_eval_variables` warns).  The reference regime is
reachable through the Python entry points only.
"""

from __future__ import annotations

import argparse
import logging
import sys

GRAIN_REFUSAL = ("--loader grain: the grain input pipeline (data/grain_loader.py of the JAX package) "
                 "is not ported; use --loader prefetch")


def _model_cfg(args):
    from anystereo_tpu_torch.config import AggregationType, CoreType, LiifConfig, ModelConfig

    return ModelConfig(
        core=CoreType(args.core),
        max_disp=args.max_disp,
        corr_levels=args.corr_levels if args.corr_levels else (2 if args.core == "igev" else 4),
        corr_radius=args.corr_radius,
        n_gru_layers=args.n_gru_layers,
        agg_type=AggregationType(args.agg_type),
        slow_fast_gru=args.slow_fast_gru,
        liif=LiifConfig(),
    )


def _add_model_flags(p):
    p.add_argument("--core", choices=["igev", "raft"], default="igev")
    p.add_argument("--max-disp", type=int, default=192)
    p.add_argument("--corr-levels", type=int, default=None)
    p.add_argument("--corr-radius", type=int, default=4)
    p.add_argument("--n-gru-layers", type=int, default=3)
    p.add_argument("--agg-type", default="type5")
    p.add_argument("--slow-fast-gru", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where the model runs: the CUDA card (default), or 'cpu' by name")


def train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("anystereo train")
    _add_model_flags(p)
    p.add_argument("--datasets", nargs="+", default=["sceneflow"])
    p.add_argument("--data-root", required=True)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--num-steps", type=int, default=100_000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--train-iters", type=int, default=16)
    p.add_argument("--multi-scale", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="--no-multi-scale selects the reference's standard "
                        "dense-crop training mode")
    p.add_argument("--noyjitter", action="store_true",
                   help="disable the ±2 px imperfect-rectification y-jitter "
                        "(ON by default, matching train_continuous_IGEV.py)")
    p.add_argument("--inp-size", type=int, nargs=2, default=[160, 320])
    p.add_argument("--scale-min", type=float, default=1.0)
    p.add_argument("--scale-max", type=float, default=2.95)
    p.add_argument("--supervise-init", action="store_true")
    p.add_argument("--restore", default=None,
                   help="checkpoint dir to warm-start weights from (the "
                        "reference's --restore_ckpt fine-tune flow: filtered "
                        "params-only load, fresh schedule); the CLI builds the "
                        "GroupNorm model, so a converted reference checkpoint's "
                        "BatchNorm tensors are not loaded (reference_regime_config "
                        "is reachable from Python only)")
    p.add_argument("--ckpt-dir", default="checkpoints")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--loader", choices=["prefetch", "grain"], default="prefetch",
                   help="'grain' = deterministic checkpointable input "
                        "pipeline of the JAX package; not ported, refused")
    # in-training held-out validation every --ckpt-every steps (the
    # reference validates every valid_fre, train_continuous_IGEV.py:242-264)
    p.add_argument("--val-dataset", default=None,
                   help="held-out split for in-training validation "
                        "(e.g. sceneflow, kitti15, middlebury_H)")
    p.add_argument("--val-root", default=None,
                   help="dataset root for --val-dataset (defaults to --data-root)")
    p.add_argument("--valid-iters", type=int, default=32)
    p.add_argument("--val-max-images", type=int, default=None)
    p.add_argument("--multihost", action="store_true",
                   help="initialize torch.distributed from cluster env vars "
                        "(COORDINATOR_ADDRESS etc., or torchrun's) and train "
                        "data-parallel over every rank")
    return p


def cmd_train(argv) -> int:
    args = train_parser().parse_args(argv)
    if args.loader == "grain":
        print(GRAIN_REFUSAL, file=sys.stderr)
        return 2

    from anystereo_tpu_torch.config import Config, DataConfig, MeshConfig, TrainConfig
    from anystereo_tpu_torch.data.augment import AugmentorConfig
    from anystereo_tpu_torch.data.datasets import fetch_dataset
    from anystereo_tpu_torch.data.loader import PrefetchLoader
    from anystereo_tpu_torch.train.trainer import train
    from anystereo_tpu_torch.utils.device import process_topology

    if args.multihost:
        from anystereo_tpu_torch.parallel.mesh import maybe_initialize_distributed

        maybe_initialize_distributed(require=True, device=args.device)

    cfg = Config(
        model=_model_cfg(args),
        train=TrainConfig(
            lr=args.lr,
            num_steps=args.num_steps,
            batch_size=args.batch_size,
            train_iters=args.train_iters,
            multi_scale=args.multi_scale,
            inp_size=tuple(args.inp_size),
            scale_min=args.scale_min,
            scale_max=args.scale_max,
            supervise_init=args.supervise_init,
            ckpt_dir=args.ckpt_dir,
        ),
        data=DataConfig(
            train_datasets=tuple(args.datasets),
            root=args.data_root,
            num_workers=args.num_workers,
            yjitter=not args.noyjitter,
        ),
        # every rank of the group on the data axis (1 without --multihost)
        mesh=MeshConfig(data=process_topology()[1]),
    )
    # y-jitter defaults ON like the reference trainer; sparse datasets ignore it
    aug = AugmentorConfig(
        crop_size=(args.inp_size[0], args.inp_size[1]),
        yjitter=not args.noyjitter,
    )
    roots = {name: args.data_root for name in
             ("sceneflow", "kitti12", "kitti15", "middlebury", "eth3d",
              "sintel", "falling_things", "tartanair")}
    dataset = fetch_dataset(
        args.datasets, roots, aug,
        multi_scale=args.multi_scale,
        scale_min=args.scale_min, scale_max=args.scale_max,
        inp_size=tuple(args.inp_size),
    )
    loader = PrefetchLoader(
        dataset, cfg.train.batch_size, num_workers=args.num_workers,
        seed=cfg.train.seed,
    )
    validate_fn = None
    if args.val_dataset is not None:
        from anystereo_tpu_torch.eval.validate import make_train_validate_fn

        validate_fn = make_train_validate_fn(
            cfg.model,
            args.val_dataset,
            args.val_root or args.data_root,
            valid_iters=args.valid_iters,
            max_images=args.val_max_images,
            device=args.device,
        )
    train(cfg, loader, validate_fn=validate_fn, warm_start=args.restore, device=args.device)
    return 0


def evaluate_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("anystereo evaluate")
    _add_model_flags(p)
    p.add_argument("--dataset", default="sceneflow",
                   choices=["sceneflow", "kitti15", "kitti12", "eth3d",
                            "middlebury_F", "middlebury_H", "middlebury_Q",
                            "middlebury_Q_F", "middlebury_H_F",
                            "middlebury_2014"])
    p.add_argument("--data-root", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--valid-iters", type=int, default=32)
    p.add_argument("--scale-test", type=float, default=1.0)
    p.add_argument("--multi-evaothers", action="store_true",
                   help="reference --multi_evaothers: bicubic-downscale "
                        "inputs by scale-test, infer plainly, and bicubic-"
                        "upscale the disparity back — the non-LIIF "
                        "comparison baseline (evaluation_validate.py:109-118)")
    p.add_argument("--shape-buckets", type=int, default=None,
                   help="pad images up to multiples of this (e.g. 64) so "
                        "mixed-size datasets share compiled executables; "
                        "must be a multiple of the model divis")
    return p


def cmd_evaluate(argv) -> int:
    args = evaluate_parser().parse_args(argv)

    from anystereo_tpu_torch.eval.validate import run_validation

    results = run_validation(
        model_cfg=_model_cfg(args),
        ckpt_dir=args.ckpt,
        dataset=args.dataset,
        data_root=args.data_root,
        valid_iters=args.valid_iters,
        scale_test=args.scale_test,
        eval_others=args.multi_evaothers,
        bucket=args.shape_buckets,
        device=args.device,
    )
    for k, v in sorted(results.items()):
        print(f"{k}: {v:.4f}")
    return 0


def cmd_bench(argv) -> int:
    from anystereo_tpu_torch import bench

    return bench.main(argv)


COMMANDS = {"train": cmd_train, "evaluate": cmd_evaluate, "bench": cmd_bench}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)-7s [%(filename)s:%(lineno)d] %(message)s",
    )
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m anystereo_tpu_torch.cli {{{'|'.join(COMMANDS)}}} ...")
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main() or 0)
