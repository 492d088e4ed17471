"""Learning sanity: one synthetic constant-disparity batch, the IGEV model
trained on it over and over; the final iteration's EPE must fall below
1 px.  The port's counterpart of the repo's `tools/overfit_sanity.py`
(a module-level script there), with its batch, recipe and verdict line.

  python -m anystereo_tpu_torch.tools.overfit_sanity [--steps 400] [--lr 4e-4] [--device cpu]

Exit code 0 when it prints LEARNED, 1 for NOT_LEARNED.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from anystereo_tpu_torch.tools.make_synthetic_datasets import gaussian_blur

D_TRUE = 6.0
B, H, W, Q = 2, 64, 128, 1024


def make_batch():
    """The batch as numpy arrays: B pairs of a blurred-noise texture (sigma
    1.5, x 255, float32) whose right view is the texture D_TRUE columns
    further left, Q uniform queries in (-0.95, 0.95), ground truth D_TRUE
    everywhere and D_TRUE / 4 at 1/4 resolution."""
    rng = np.random.RandomState(0)

    def make_pair():
        # smooth random texture so matching is well-posed
        tex = rng.rand(H, W + 32, 3).astype(np.float32)
        tex = gaussian_blur(tex, 1.5) * 255
        left = tex[:, 32:]
        right = tex[:, 32 - int(D_TRUE):W + 32 - int(D_TRUE)]
        return left, right

    pairs = [make_pair() for _ in range(B)]
    return {
        "left": np.stack([p[0] for p in pairs]),
        "right": np.stack([p[1] for p in pairs]),
        "coords": (rng.rand(B, Q, 2).astype(np.float32) * 2 - 1) * 0.95,
        "gt": np.full((B, Q), D_TRUE, np.float32),
        "valid": np.ones((B, Q), np.float32),
        "scale": np.ones((B,), np.float32),
        "gt_low": np.full((B, H // 4, W // 4), D_TRUE / 4.0, np.float32),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--lr", type=float, default=4e-4)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from anystereo_tpu_torch.config import ModelConfig, TrainConfig
    from anystereo_tpu_torch.data.loader import to_device
    from anystereo_tpu_torch.nn.model import build_model
    from anystereo_tpu_torch.train.state import create_train_state
    from anystereo_tpu_torch.train.step import make_train_step
    from anystereo_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    batch = to_device(make_batch(), device)
    tcfg = TrainConfig(train_iters=4, batch_size=B, lr=args.lr, num_steps=args.steps,
                       supervise_init=True, warmup_frac=0.05)
    model = build_model(ModelConfig(max_disp=64), device, seed=0)
    state = create_train_state(model, tcfg, device)
    step = make_train_step(model, tcfg, device=device)
    t0 = time.time()
    for i in range(args.steps):
        state, m = step(state, batch)
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(m['loss']):8.4f}  epe {float(m['epe']):7.3f}  "
                  f"1px {float(m['1px']):.3f}", flush=True)
    print(f"total {time.time() - t0:.1f}s", flush=True)
    epe = float(m["epe"])
    print("LEARNED" if epe < 1.0 else "NOT_LEARNED", f"final epe {epe:.3f}")
    return 0 if epe < 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
