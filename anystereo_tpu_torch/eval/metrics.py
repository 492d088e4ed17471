"""Evaluation metrics (twin of `anystereo_tpu/eval/metrics.py`):

  * `epe_metric`: masked mean absolute error, per image, then over the images;
  * `d1_metric`: error > 3 px and > 5% of |gt|;
  * `thres_metric`: error > t px;
  * the cover rule: a sub-mask (occluded, non-occluded) of an image counts
    only when it covers at least 1% of the valid ground-truth pixels.

Inputs are [B, H, W] (or [B, Q]) tensors; the metrics are fp32 scalars.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _per_image_masked_mean(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the valid pixels of each image, then over the images that
    have any.  Masked-out values are dropped with `where`, not multiplied by
    0: an inf ground truth at an invalid pixel must not reach the sum."""
    m = mask.float()
    axes = tuple(range(1, value.dim()))
    value = torch.where(m > 0, value, torch.zeros((), dtype=value.dtype, device=value.device))
    count = m.sum(axes)
    per_img = value.sum(axes) / count.clamp_min(1.0)
    has = (count > 0).float()
    return (per_img * has).sum() / has.sum().clamp_min(1.0)


def epe_metric(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _per_image_masked_mean((pred - gt).abs(), mask)


def d1_metric(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    err = (pred - gt).abs()
    # written as ~(ok), so that a non-finite prediction counts as bad
    bad = ~((err <= 3.0) | (err <= 0.05 * gt.abs()))
    return _per_image_masked_mean(bad.float(), mask)


def thres_metric(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                 thres: float) -> torch.Tensor:
    err = (pred - gt).abs()
    return _per_image_masked_mean((~(err <= thres)).float(), mask)


def mask_cover_ok(mask: torch.Tensor, valid: torch.Tensor, frac: float = 0.01) -> bool:
    """Whether `mask` covers at least `frac` of the valid pixels."""
    return bool(mask.sum() >= frac * max(float(valid.sum()), 1.0))


def compute_metrics(pred: torch.Tensor, gt: torch.Tensor, valid: torch.Tensor,
                    occ: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """EPE / D1 / Thres{1,2,3} over all valid pixels and, when an occlusion
    mask is given, over its occluded and non-occluded parts (`_occ`, `_noc`),
    each subject to the cover rule.  valid, occ: boolean."""
    out = {}

    def add(suffix, m):
        out[f"epe{suffix}"] = float(epe_metric(pred, gt, m))
        out[f"d1{suffix}"] = float(d1_metric(pred, gt, m))
        for t in (1.0, 2.0, 3.0):
            out[f"thres{int(t)}{suffix}"] = float(thres_metric(pred, gt, m, t))

    add("", valid)
    if occ is not None:
        for suffix, m in (("_occ", valid & occ), ("_noc", valid & ~occ)):
            if mask_cover_ok(m, valid):
                add(suffix, m)
    return out


def iou_metric(pred_mask: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    """Binary-mask IoU per image, averaged."""
    p, g = pred_mask.bool(), gt_mask.bool()
    axes = tuple(range(1, p.dim()))
    inter = (p & g).sum(axes).float()
    union = (p | g).sum(axes).float()
    return (inter / union.clamp_min(1.0)).mean()


class AverageMeterDict:
    """Running means over per-image metric dicts."""

    def __init__(self):
        self.sums: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def update(self, d: Dict[str, float]) -> None:
        for k, v in d.items():
            if v is None:
                continue
            # non-finite values are summed, not dropped: a NaN per-image
            # metric must surface as a NaN mean, not vanish from the result
            self.sums[k] = self.sums.get(k, 0.0) + float(v)
            self.counts[k] = self.counts.get(k, 0) + 1

    def mean(self) -> Dict[str, float]:
        return {k: self.sums[k] / self.counts[k] for k in self.sums}
