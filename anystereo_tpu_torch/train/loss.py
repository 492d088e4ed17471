"""Training losses (twin of `anystereo_tpu/train/loss.py`).

* `sequence_loss_queries`: exponentially weighted L1 over the GRU iterates
  on flattened query tensors, weight gamma'^(N-1-i) with
  gamma' = gamma^(15/(N-1));
* `sequence_loss`: the same on dense grids;
* `init_disp_loss`: smooth-L1 on the regressed initial disparity against
  the 1/4-res ground truth.

All losses mask by (valid >= 0.5) & (|gt| < max_disp), compute in fp32 and
return (loss, metrics-dict).  Each masked mean divides by the batch's count
of valid entries, or by `count` where given: a data-parallel step passes
the count over every rank's slice of the batch (`query_mask`, `low_mask`),
so that each rank's loss and metrics are its share of the full batch's, and
their sums over the ranks are the full batch's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def _iter_weights(n: int, gamma: float, device=None) -> torch.Tensor:
    """gamma' = gamma**(15/(n-1)); w_i = gamma'**(n-1-i)."""
    adj = gamma ** (15.0 / (n - 1)) if n > 1 else gamma
    i = torch.arange(n, dtype=torch.float32, device=device)
    return adj ** (n - 1 - i)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, count: Optional[torch.Tensor] = None) -> torch.Tensor:
    return (x * mask).sum() / (mask.sum() if count is None else count).clamp_min(1.0)


def query_mask(gt: torch.Tensor, valid: torch.Tensor, max_disp: float) -> torch.Tensor:
    """The entries `sequence_loss_queries` averages over, as 0/1 floats."""
    return ((valid >= 0.5) & (gt.float().abs() < max_disp)).float()


def low_mask(gt_low: torch.Tensor, max_disp: float) -> torch.Tensor:
    """The entries `init_disp_loss` averages over, as 0/1 floats."""
    return (gt_low.float().abs() < max_disp / 4.0).float()


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """F.smooth_l1_loss elementwise."""
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def sequence_loss_queries(
    disp_preds: torch.Tensor,
    gt: torch.Tensor,
    valid: torch.Tensor,
    max_disp: float = 700.0,
    gamma: float = 0.9,
    count: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Query-space sequence loss.  disp_preds: [iters, B, Q]; gt, valid:
    [B, Q]; `count`: the number of valid queries to divide by (default:
    this batch's)."""
    n = disp_preds.shape[0]
    gt = gt.float()
    mask = query_mask(gt, valid, max_disp)
    if count is None:
        count = mask.sum()
    w = _iter_weights(n, gamma, disp_preds.device)
    err = (disp_preds.float() - gt[None]).abs()  # [iters, B, Q]
    per_iter = (err * mask[None]).sum(dim=(1, 2)) / count.clamp_min(1.0)
    loss = (w * per_iter).sum()
    final_err = err[-1].detach()
    metrics = {
        "epe": _masked_mean(final_err, mask, count),
        "1px": _masked_mean((final_err < 1.0).float(), mask, count),
        "3px": _masked_mean((final_err < 3.0).float(), mask, count),
    }
    return loss, metrics


def sequence_loss(
    disp_preds: torch.Tensor,
    gt: torch.Tensor,
    valid: torch.Tensor,
    max_disp: float = 700.0,
    gamma: float = 0.9,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Dense-grid sequence loss.  disp_preds: [iters, B, H, W]; gt, valid:
    [B, H, W]."""
    it, b = disp_preds.shape[0], disp_preds.shape[1]
    return sequence_loss_queries(disp_preds.reshape(it, b, -1), gt.reshape(b, -1),
                                 valid.reshape(b, -1), max_disp, gamma)


def init_disp_loss(init_disp: torch.Tensor, gt_low: torch.Tensor, max_disp: float,
                   count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Initial-disparity supervision: smooth-L1 against the 1/4-res ground
    truth (already divided by 4*scale), masked by |gt| < max_disp/4.
    init_disp, gt_low: [B, H/4, W/4]; `count` as in `sequence_loss_queries`."""
    gt_low = gt_low.float()
    return _masked_mean(smooth_l1(init_disp.float(), gt_low), low_mask(gt_low, max_disp), count)
