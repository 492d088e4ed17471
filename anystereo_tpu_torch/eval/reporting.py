"""Validation reporting (twin of `anystereo_tpu/eval/reporting.py`):
append-only text reports, colored disparity PNGs, error maps, and
TensorBoard scalars/images.

Spec: the reference's --record / --output / --ShowImage flags
(evaluation_validate.py:319-332, 648-658; save_scalars/save_images at
metrics_utils/experiment.py:61-88).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from anystereo_tpu_torch.eval.visualization import disp_error_image, disp_to_color, save_png


def append_result_line(path: str, name: str, metrics: Dict[str, float]) -> None:
    """result.txt-style append (evaluation_validate.py:319-321)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    parts = " ".join(f"{k}={v:.3f}" for k, v in sorted(metrics.items()))
    with open(path, "a", encoding="utf-8") as f:
        f.write(f"{name} {parts}\n")


def write_summary(path: str, results: Dict[str, float], header: str = "") -> None:
    """Final aggregated report block (evaluation_validate.py:648-658)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        if header:
            f.write(f"== {header} ==\n")
        for k, v in sorted(results.items()):
            f.write(f"{k}: {v:.4f}\n")


def dump_disparity_png(out_dir: str, name: str, disp: np.ndarray,
                       max_disp: Optional[float] = None) -> str:
    """Colored disparity dump (Disp_to_color, evaluation.py:35-65)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"disp_{name}.png")
    save_png(path, disp_to_color(disp, max_disp))
    return path


def dump_error_map_png(out_dir: str, name: str, pred: np.ndarray,
                       gt: np.ndarray, valid: Optional[np.ndarray] = None) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"errmap_{name}.png")
    save_png(path, disp_error_image(pred, gt, valid))
    return path


class TensorBoardReporter:
    """Scalar/image writer (save_scalars/save_images equivalents) through
    `torch.utils.tensorboard`; no-op when it does not import."""

    def __init__(self, logdir: str):
        self.writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self.writer = SummaryWriter(logdir)

    def scalars(self, tag: str, metrics: Dict[str, float], step: int) -> None:
        if self.writer is None:
            return
        for k, v in metrics.items():
            self.writer.add_scalar(f"{tag}/{k}", float(v), step)

    def image(self, tag: str, img: np.ndarray, step: int) -> None:
        """img: [H, W, 3] or [H, W] uint8."""
        if self.writer is None:
            return
        if img.ndim == 2:
            img = img[..., None]
        self.writer.add_image(tag, img.astype(np.float32) / 255.0, step, dataformats="HWC")

    def flush(self) -> None:
        if self.writer is not None:
            self.writer.flush()
