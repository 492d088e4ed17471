"""Write synthetic dataset trees in the SceneFlow, KITTI 2012/2015,
Middlebury (MiddEval3 F/H/Q) and ETH3D layouts that `data/datasets.py`
globs, so that every evaluation protocol and the baseline recipe
(`tools/reproduce_baseline.py`: train, checkpoint, evaluate, table) can be
rehearsed end to end without the real datasets.

The port's counterpart of the repo's `tools/make_synthetic_datasets.py`:
the same functions, defaults, seeds and trees, written without OpenCV or
PIL.  A pair is a blurred-noise texture and a smooth disparity field, the
right view the texture resampled at x + margin - d, so a trained model gives
meaningful EPEs.  The arithmetic is OpenCV's, redone in numpy and scipy
(the card's host has neither OpenCV nor PIL):

  * `gaussian_blur`: `cv2.GaussianBlur(a, (0, 0), sigma)` of float32, a
    kernel of round(8 sigma + 1) | 1 taps and the reflect-101 border, as two
    separable passes;
  * `remap_x`: `cv2.remap(..., INTER_LINEAR)` along x, v0 + (v1 - v0) * f at
    the exact coordinate, one rounding (OpenCV 5's float remap; its older
    1/32-quantised tables put 11% of the right view's pixels a level off);
  * `area_downsample`: `cv2.resize(..., INTER_AREA)` at the integer factors
    2 and 4: each output a block's mean (uint8: (sum + 2) >> 2 at 2, the
    mean rounded half to even at 4; float32: each block row summed left to
    right, the rows summed, times 1 / s^2);
  * PNGs through `data/png.write_png`, KITTI's 16-bit disparity as
    disp * 256 in uint16, PFMs through `data/frame_utils.write_pfm`.

  python -m anystereo_tpu_torch.tools.make_synthetic_datasets --out DIR \\
      [--seed 0] [--sceneflow-n 4] [--device cpu]

`--device` is where the sanity check's SceneFlow occlusion provider would
run (default: the CUDA card; without one it raises unless `--device cpu`).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

PROTOCOLS = ("sceneflow", "kitti15", "kitti12", "eth3d", "middlebury_F", "middlebury_H",
             "middlebury_Q", "middlebury_Q_F", "middlebury_H_F")


def gaussian_blur(a: np.ndarray, sigma: float) -> np.ndarray:
    """`cv2.GaussianBlur(a, (0, 0), sigma)` of a float32 [H, W] or [H, W, C]
    array: OpenCV's float kernel size round(8 sigma + 1) | 1, normalised
    exp(-x^2 / 2 sigma^2) taps, reflect-101 border, x then y."""
    from scipy.ndimage import correlate1d

    n = int(round(sigma * 8 + 1)) | 1
    x = np.arange(n) - (n - 1) / 2
    k = np.exp(-x * x / (2 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    out = correlate1d(np.asarray(a, np.float32), k, axis=1, mode="mirror")
    return correlate1d(out, k, axis=0, mode="mirror")


def remap_x(src: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """`cv2.remap(src, xs, rows, cv2.INTER_LINEAR)` of a float32 [H, W] image
    where row y of the map samples row y of `src`: v0 + (v1 - v0) * f with
    f = x - floor(x), one float32 rounding.  `xs` [H, W'] lies in [0, W - 1]."""
    src = np.asarray(src, np.float32)
    xs = np.asarray(xs, np.float32)
    if xs.min() < 0 or xs.max() > src.shape[1] - 1:
        raise ValueError(f"remap_x: positions {xs.min()}..{xs.max()} leave the row of {src.shape[1]}")
    x0 = np.floor(xs).astype(np.int64)
    x1 = np.minimum(x0 + 1, src.shape[1] - 1)
    f = xs - x0.astype(np.float32)
    v0 = np.take_along_axis(src, x0, 1)
    dv = np.take_along_axis(src, x1, 1) - v0
    # the product of two float32s is exact in float64: one rounding, as a fused multiply-add
    return (v0.astype(np.float64) + dv.astype(np.float64) * f).astype(np.float32)


def area_downsample(a: np.ndarray, s: int) -> np.ndarray:
    """`cv2.resize(a, (W // s, H // s), interpolation=cv2.INTER_AREA)` for
    s in (1, 2, 4) of a uint8 [H, W(, C)] or float32 [H, W] array with H and
    W multiples of s (module docstring)."""
    if s == 1:
        return a.copy()
    if s not in (2, 4):
        raise ValueError(f"area_downsample: factor {s} is not 1, 2 or 4")
    h, w = a.shape[0] // s, a.shape[1] // s
    blocks = a.reshape(h, s, w, s, *a.shape[2:])
    if a.dtype == np.uint8:
        total = blocks.astype(np.int64).sum((1, 3))
        out = (total + 2) >> 2 if s == 2 else np.rint(total / (s * s))
        return out.astype(np.uint8)
    if a.dtype != np.float32:
        raise ValueError(f"area_downsample wants uint8 or float32, got {a.dtype}")
    acc = None
    for i in range(s):
        row = blocks[:, i, :, 0].copy()
        for j in range(1, s):
            row += blocks[:, i, :, j]
        acc = row if acc is None else acc + row
    return acc * np.float32(1.0 / (s * s))


def make_pair(rng, h, w, dmin=4.0, dmax=14.0):
    """(left, right, disp): textured pair with right = warp(left, disp)."""
    margin = int(np.ceil(dmax)) + 10
    tex = gaussian_blur(rng.rand(h, w + margin, 3).astype(np.float32), 1.2)
    tex = (tex - tex.min()) / (tex.max() - tex.min()) * 255
    dgrid = gaussian_blur(rng.rand(h, w).astype(np.float32), 12)
    dgrid = dmin + (dmax - dmin) * (
        (dgrid - dgrid.min()) / max(float(np.ptp(dgrid)), 1e-6)
    )
    left = tex[:, margin:]
    xs = np.arange(w)[None, :] + margin - dgrid
    right = np.stack([remap_x(tex[..., c], xs.astype(np.float32)) for c in range(3)], axis=-1)
    return left.astype(np.uint8), right.astype(np.uint8), dgrid.astype(np.float32)


def _save_png(path, arr):
    from anystereo_tpu_torch.data.png import write_png

    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path, arr)


def _save_pfm(path, arr):
    from anystereo_tpu_torch.data.frame_utils import write_pfm

    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_pfm(path, arr)


def _save_kitti_disp(path, disp):
    """KITTI sparse uint16 PNG: disp*256, 0 = invalid."""
    _save_png(path, (disp * 256.0).astype(np.uint16))


def gen_sceneflow(root, rng, n_train=4, n_test=4, h=200, w=400):
    # >= the reference train recipe's 160x320 crop so the augmentor can
    # crop without padding
    """frames_finalpass/{TRAIN,TEST}/A/0000/left/NNNN.png + disparity twin
    (SceneFlowDataset._add_things glob: {split}/*/*/left/*.png)."""
    for split, n in (("TRAIN", n_train), ("TEST", n_test)):
        for i in range(n):
            l, r, d = make_pair(rng, h, w)
            base = os.path.join(root, "frames_finalpass", split, "A", "0000")
            _save_png(os.path.join(base, "left", f"{i:04d}.png"), l)
            _save_png(os.path.join(base, "right", f"{i:04d}.png"), r)
            _save_pfm(
                os.path.join(root, "disparity", split, "A", "0000", "left",
                             f"{i:04d}.pfm"), d)


def gen_kitti15(root, rng, n=3, h=120, w=376):
    """training/image_2|image_3|disp_occ_0 (+disp_noc_0 for the occ split)."""
    for i in range(n):
        l, r, d = make_pair(rng, h, w)
        name = f"{i:06d}_10.png"
        _save_png(os.path.join(root, "training", "image_2", name), l)
        _save_png(os.path.join(root, "training", "image_3", name), r)
        occ = d.copy()
        occ[rng.rand(h, w) < 0.3] = 0  # sparse GT
        noc = occ.copy()
        noc[:, : w // 8] = 0  # a band valid only in the occ GT
        _save_kitti_disp(os.path.join(root, "training", "disp_occ_0", name), occ)
        _save_kitti_disp(os.path.join(root, "training", "disp_noc_0", name), noc)


def gen_kitti12(root, rng, n=3, h=120, w=376):
    """training/colored_0|colored_1|disp_occ (+disp_noc)."""
    for i in range(n):
        l, r, d = make_pair(rng, h, w)
        name = f"{i:06d}_10.png"
        _save_png(os.path.join(root, "training", "colored_0", name), l)
        _save_png(os.path.join(root, "training", "colored_1", name), r)
        occ = d.copy()
        occ[rng.rand(h, w) < 0.3] = 0
        noc = occ.copy()
        noc[:, : w // 8] = 0
        _save_kitti_disp(os.path.join(root, "training", "disp_occ", name), occ)
        _save_kitti_disp(os.path.join(root, "training", "disp_noc", name), noc)


def gen_middlebury(root, rng, scenes=("scene_a", "scene_b"), hf=192, wf=256):
    """MiddEval3/training{F,H,Q}/<scene>/{im0,im1}.png + disp0GT.pfm +
    mask0nocc.png, with F/H/Q at full/half/quarter resolution and the F GT
    exactly 2x the H / 4x the Q image size (the Q_F/H_F fixed-upscale
    protocols divide these)."""
    for scene in scenes:
        lf, rf, df = make_pair(rng, hf, wf, dmax=20.0)
        for split, s in (("F", 1), ("H", 2), ("Q", 4)):
            h, w = hf // s, wf // s
            l = area_downsample(lf, s)
            r = area_downsample(rf, s)
            d = area_downsample(df, s) / s
            base = os.path.join(root, "MiddEval3", f"training{split}", scene)
            _save_png(os.path.join(base, "im0.png"), l)
            _save_png(os.path.join(base, "im1.png"), r)
            gt = d.copy()
            gt[: h // 10] = np.inf  # missing-GT band (PFM inf convention)
            _save_pfm(os.path.join(base, "disp0GT.pfm"), gt)
            nocc = np.full((h, w), 255, np.uint8)
            nocc[:, : w // 6] = 128  # occluded band WITH GT
            _save_png(os.path.join(base, "mask0nocc.png"), nocc)


def gen_eth3d(root, rng, scenes=("playground_1l", "forest_2s"), h=120, w=224):
    """two_view_training/<scene>/im{0,1}.png +
    two_view_training_gt/<scene>/disp0GT.pfm + mask0nocc.png."""
    for scene in scenes:
        l, r, d = make_pair(rng, h, w)
        imdir = os.path.join(root, "two_view_training", scene)
        gtdir = os.path.join(root, "two_view_training_gt", scene)
        _save_png(os.path.join(imdir, "im0.png"), l)
        _save_png(os.path.join(imdir, "im1.png"), r)
        gt = d.copy()
        gt[: h // 10] = np.inf
        _save_pfm(os.path.join(gtdir, "disp0GT.pfm"), gt)
        nocc = np.full((h, w), 255, np.uint8)
        nocc[:, : w // 6] = 0
        _save_png(os.path.join(gtdir, "mask0nocc.png"), nocc)


def generate_all(out: str, seed: int = 0, sceneflow_n: int = 4):
    rng = np.random.RandomState(seed)
    gen_sceneflow(out, rng, n_train=sceneflow_n, n_test=sceneflow_n)
    gen_kitti15(out, rng)
    gen_kitti12(out, rng)
    gen_middlebury(out, rng)
    gen_eth3d(out, rng)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sceneflow-n", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from anystereo_tpu_torch.eval.validate import build_eval_dataset
    from anystereo_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    generate_all(args.out, args.seed, args.sceneflow_n)
    # sanity: every dataset class must see its files
    for key in PROTOCOLS:
        ds, *_ = build_eval_dataset(key, args.out, device)
        print(f"{key:16s} {len(ds)} images")
        if len(ds) == 0:
            raise RuntimeError(f"{key}: no images under {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
