"""Visualization (twin of `anystereo_tpu/eval/visualization.py`):
KITTI-style disparity error maps and colored disparity images (numpy;
consumed by TensorBoard or written as PNGs by the port's own encoder).

Spec: metrics_utils/visualization.py:11-58 (disp_error_image_func — 10-bin
log-scaled error colormap with a legend strip) and the KITTI disparity
colormap of evaluation.py:35-65 (Disp_to_color).
"""

from __future__ import annotations

import numpy as np

from anystereo_tpu_torch.data.png import write_png

# 10-bin error colormap (visualization.py:14-24): [low, high, r, g, b]
_ERROR_BINS = np.array(
    [
        [0 / 3.0, 0.1875 / 3.0, 49, 54, 149],
        [0.1875 / 3.0, 0.375 / 3.0, 69, 117, 180],
        [0.375 / 3.0, 0.75 / 3.0, 116, 173, 209],
        [0.75 / 3.0, 1.5 / 3.0, 171, 217, 233],
        [1.5 / 3.0, 3 / 3.0, 224, 243, 248],
        [3 / 3.0, 6 / 3.0, 254, 224, 144],
        [6 / 3.0, 12 / 3.0, 253, 174, 97],
        [12 / 3.0, 24 / 3.0, 244, 109, 67],
        [24 / 3.0, 48 / 3.0, 215, 48, 39],
        [48 / 3.0, np.inf, 165, 0, 38],
    ],
    dtype=np.float64,
)


def disp_error_image(
    pred: np.ndarray, gt: np.ndarray, valid: np.ndarray | None = None
) -> np.ndarray:
    """[H, W] pred/gt → [H, W, 3] uint8 error map.  Error measure:
    min(|err|/3, |err|/gt/0.05) binned into the KITTI 10-color scale;
    invalid pixels black (visualization.py:30-52)."""
    gt = gt.astype(np.float64)
    pred = pred.astype(np.float64)
    if valid is None:
        valid = gt > 0
    err = np.abs(pred - gt)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(gt > 0, err / np.maximum(gt, 1e-9) / 0.05, np.inf)
    measure = np.minimum(err / 3.0, rel)
    out = np.zeros((*gt.shape, 3), np.uint8)
    for lo, hi, r, g, b in _ERROR_BINS:
        m = (measure >= lo) & (measure < hi) & valid
        out[m] = (r, g, b)
    out[~valid.astype(bool)] = 0
    return out


# KITTI disparity colormap control points (evaluation.py:38-46 weights/bins)
_KITTI_MAP = np.array(
    [
        [0, 0, 0, 114],
        [0, 0, 1, 185],
        [1, 0, 0, 114],
        [1, 0, 1, 174],
        [0, 1, 0, 114],
        [0, 1, 1, 185],
        [1, 1, 0, 114],
        [1, 1, 1, 0],
    ],
    dtype=np.float64,
)


def disp_to_color(disp: np.ndarray, max_disp: float | None = None) -> np.ndarray:
    """[H, W] disparity → [H, W, 3] uint8 with the KITTI devkit colormap
    (evaluation.py:35-65)."""
    disp = np.asarray(disp, np.float64)
    if max_disp is None:
        max_disp = max(float(disp.max()), 1e-6)
    d = np.clip(disp / max_disp, 0, 1)

    bins = _KITTI_MAP[:-1, 3]
    cbins = np.cumsum(bins)
    total = cbins[-1]
    d_scaled = d * total
    ind = np.searchsorted(cbins, d_scaled, side="right")
    ind = np.clip(ind, 0, len(bins) - 1)
    prev = np.where(ind > 0, cbins[ind - 1], 0.0)
    t = (d_scaled - prev) / bins[ind]
    c0 = _KITTI_MAP[ind, :3]
    c1 = _KITTI_MAP[ind + 1, :3]
    rgb = (1 - t)[..., None] * c0 + t[..., None] * c1
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def save_png(path: str, img: np.ndarray) -> None:
    write_png(path, img)
