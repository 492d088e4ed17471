"""The gate before a real-data accuracy campaign: point it at a dataset
mount and it says what the port can train and evaluate there.

  python -m anystereo_tpu_torch.tools.check_datasets --data-root /datasets [--smoke] [--device cpu]

For every dataset protocol the reference defines (stereo_datasets.py:
252-540 glob layouts) it:
  1. resolves the dataset under the root (probing common subdirectory
     aliases), reports the sample count and the expected tree when absent;
  2. verifies that the first sample decodes (images and ground truth);
  3. with --smoke: runs a 5-image eval smoke (random weights: it checks the
     protocol machinery, not accuracy) and a 20-step train smoke through
     `python -m anystereo_tpu_torch.cli train` on the first available
     training set;
  4. prints the `reproduce_baseline` command for the 100k-step run.

The port's counterpart of the repo's `tools/check_datasets.py`.  Exit 0 if
at least one training dataset and one eval protocol resolve.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# eval protocols (build_eval_dataset keys) and the tree each one expects
EVAL_SPECS = [
    ("sceneflow", "frames_finalpass/TEST/*/*/left/*.png (+ disparity/)"),
    ("kitti15", "training/image_2|image_3|disp_occ_0|disp_noc_0/*_10.png"),
    ("kitti12", "training/colored_0|colored_1|disp_occ|disp_noc/*_10.png"),
    ("middlebury_F", "MiddEval3/trainingF/<scene>/{im0,im1}.png disp0GT.pfm mask0nocc.png"),
    ("middlebury_H", "MiddEval3/trainingH/..."),
    ("middlebury_Q", "MiddEval3/trainingQ/..."),
    ("middlebury_Q_F", "trainingQ inputs + trainingF GT (x4 protocol)"),
    ("middlebury_H_F", "trainingH inputs + trainingF GT (x2 protocol)"),
    ("eth3d", "two_view_training/*/im0.png + two_view_training_gt/*/disp0GT.pfm"),
]

# training sets (fetch_dataset names), first resolvable one used for the smoke
TRAIN_SPECS = [
    ("sceneflow", "frames_finalpass/TRAIN/... + Monkaa + Driving"),
    ("kitti_mix", "KITTI 2012+2015 training trees"),
]

# common per-dataset subdirectory aliases probed in addition to the root
ALIASES = {
    "sceneflow": ("", "sceneflow", "SceneFlow"),
    "kitti15": ("", "kitti15", "Kitti2015", "KITTI2015", "kitti/2015"),
    "kitti12": ("", "kitti12", "Kitti2012/stereoflow", "KITTI2012"),
    "middlebury": ("", "middlebury", "Middlebury"),
    "eth3d": ("", "eth3d", "ETH3D/Stereo", "ETH3D"),
}


def _alias_key(name: str) -> str:
    if name.startswith("middlebury"):
        return "middlebury"
    if name.startswith("kitti_mix"):
        return "kitti15"
    return name if name in ALIASES else "sceneflow"


def _resolve(name: str, data_root: str, device):
    """Try the root and its aliases; return (dataset, resolved_root) for the
    first candidate with samples, else (None, None)."""
    from anystereo_tpu_torch.data.datasets import KittiMixed
    from anystereo_tpu_torch.eval.validate import build_eval_dataset

    for sub in ALIASES[_alias_key(name)]:
        root = os.path.join(data_root, sub) if sub else data_root
        if not os.path.isdir(root):
            continue
        try:
            if name == "kitti_mix":
                ds = KittiMixed(root, root, aug=None, mode="mix_train")
            else:
                ds, *_ = build_eval_dataset(name, root, device)
        except Exception:  # noqa: BLE001 - a tree this protocol cannot read is absent here
            continue
        if len(ds) > 0:
            return ds, root
    return None, None


def _decode_first(ds) -> str:
    """Load sample 0 end-to-end; '' on success, error string on failure."""
    try:
        item = ds[0]
        imgs = item["left"], item["right"]
        if not all(i.ndim == 3 and i.shape[-1] == 3 for i in imgs):
            raise ValueError(f"bad image shapes {[i.shape for i in imgs]}")
        return ""
    except Exception:  # noqa: BLE001 - reported as the protocol's failure
        return traceback.format_exc(limit=2).strip().splitlines()[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", default="/datasets")
    ap.add_argument("--smoke", action="store_true",
                    help="run the 5-image eval + 20-step train smokes")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from anystereo_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if not os.path.isdir(args.data_root):
        print(f"FAIL: {args.data_root} does not exist — mount the datasets "
              "and rerun.", file=sys.stderr)
        return 1

    ok_eval, ok_train = [], []
    print(f"== dataset trees under {args.data_root} ==")
    for name, tree in EVAL_SPECS:
        ds, root = _resolve(name, args.data_root, device)
        if ds is None:
            print(f"  [absent ] {name:16s} expected: {tree}")
            continue
        err = _decode_first(ds)
        if err:
            print(f"  [BROKEN ] {name:16s} {len(ds)} samples at {root}; "
                  f"sample 0 failed: {err}")
            continue
        print(f"  [ok     ] {name:16s} {len(ds):5d} samples at {root}")
        ok_eval.append((name, root))
    for name, tree in TRAIN_SPECS:
        ds, root = _resolve(name, args.data_root, device)
        if ds is not None and not _decode_first(ds):
            print(f"  [ok     ] {name:16s} {len(ds):5d} TRAIN samples at {root}")
            ok_train.append((name, root))
        else:
            print(f"  [absent ] {name:16s} expected: {tree}")

    if args.smoke and ok_eval:
        name, root = ok_eval[0]
        print(f"== 5-image eval smoke on {name} (random weights) ==")
        from anystereo_tpu_torch.config import ModelConfig
        from anystereo_tpu_torch.eval.validate import build_eval_dataset, validate_dataset
        from anystereo_tpu_torch.nn.model import build_model

        model = build_model(ModelConfig(max_disp=64), device, seed=0)
        ds, fixed_upscale, occ_provider, valid_from_gt = build_eval_dataset(name, root, device)
        res = validate_dataset(
            model, ds, valid_iters=4, max_images=5,
            fixed_upscale=fixed_upscale, occ_provider=occ_provider,
            valid_from_gt=valid_from_gt, device=device,
        )
        print(f"  eval smoke OK: {res}")

    if args.smoke and ok_train:
        name, root = ok_train[0]
        print(f"== 20-step train smoke on {name} ==", flush=True)
        with tempfile.TemporaryDirectory(prefix="anystereo_smoke_ckpt") as ckpt:
            rc = subprocess.call([
                sys.executable, "-m", "anystereo_tpu_torch.cli", "train",
                "--data-root", root, "--datasets",
                "sceneflow" if name == "sceneflow" else "kitti_all",
                "--num-steps", "20", "--batch-size", "1", "--max-disp", "64",
                "--train-iters", "4", "--num-workers", "2",
                "--ckpt-dir", ckpt, "--device", str(device),
            ], cwd=REPO)
        print(f"  train smoke rc={rc}")
        if rc != 0:
            return 1

    print("== next ==")
    if ok_train and ok_eval:
        root = ok_train[0][1]
        print("Start the accuracy campaign (100k steps, then every eval protocol):\n"
              "  python -m anystereo_tpu_torch.tools.reproduce_baseline "
              f"--data-root {root} --ckpt ckpts/ref-repro")
        return 0
    print("FAIL: need at least one training set and one eval protocol "
          "resolvable.", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
