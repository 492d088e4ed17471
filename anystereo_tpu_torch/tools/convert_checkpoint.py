"""Convert a reference PyTorch checkpoint into a checkpoint of the port.

Imports a trained `continuous_IGEVStereo` / `continuous_RaftStereo`
state_dict (the timm mobilenetv2_100 trunk included) through
`utils/torch_convert.py` and writes it as step 0 of a checkpoint directory
in the layout of `train/state.py` (`<out>/0/checkpoint.pt`, weights only).
The model it belongs to is built with `config.reference_regime_config`
(frozen BatchNorm statistics).

  python -m anystereo_tpu_torch.tools.convert_checkpoint --torch-ckpt ref.pth \\
      --out ckpts/ref [--core raft] [--max-disp 192] [--verify] [--device cpu]

The directory feeds `run_validation` / `restore_eval_variables` (its model
built with `reference_regime_config`), `restore_params_only`, and
`train(warm_start=...)`, which is the CLI's `train --restore`.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import torch

from anystereo_tpu_torch.config import CoreType, reference_regime_config
from anystereo_tpu_torch.train.state import CHECKPOINT_FILE
from anystereo_tpu_torch.utils.torch_convert import convert_state_dict


def write_weights(out: str, sd) -> str:
    """Write `{"step": 0, "model": sd}` as step 0 of the checkpoint
    directory `out` (under a temporary name, then renamed into place);
    returns the file's path."""
    final = os.path.join(os.path.abspath(out), "0")
    if os.path.exists(final):
        raise FileExistsError(f"{final}: step 0 is already saved")
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"step": 0, "model": {k: v.contiguous() for k, v in sd.items()}},
               os.path.join(tmp, CHECKPOINT_FILE))
    os.replace(tmp, final)
    return os.path.join(final, CHECKPOINT_FILE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("convert_checkpoint")
    p.add_argument("--torch-ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--core", choices=["igev", "raft"], default="igev")
    p.add_argument("--max-disp", type=int, default=192)
    p.add_argument("--verify", action="store_true",
                   help="run one forward on a 64x96 zero pair to check that it is finite")
    p.add_argument("--device", default="cuda",
                   help="where --verify runs (default: the CUDA card; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)

    t0 = time.perf_counter()
    sd = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    cfg = reference_regime_config(core=CoreType(args.core), max_disp=args.max_disp,
                                  corr_levels=2 if args.core == "igev" else 4)
    converted = convert_state_dict(sd, cfg)
    n = sum(v.numel() for v in converted.values())
    print(f"converted {n / 1e6:.2f}M values ({len(sd)} torch tensors -> {len(converted)}) for "
          f"core={args.core} in {(time.perf_counter() - t0) * 1e3:.1f} ms")

    if args.verify:
        from anystereo_tpu_torch.nn.model import build_model

        model = build_model(cfg, args.device)
        model.load_state_dict(converted, strict=True)
        zeros = torch.zeros(1, 64, 96, 3, device=next(model.parameters()).device)
        with torch.no_grad():
            out = model.eval()(zeros, zeros, iters=2).disp_final
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("forward produced non-finite values")
        print("verify: forward finite OK")

    path = write_weights(args.out, converted)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
