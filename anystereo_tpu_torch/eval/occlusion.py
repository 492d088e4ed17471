"""Occlusion mask by left-right consistency (twin of
`anystereo_tpu/eval/occlusion.py`): the right view's disparity is warped into
the left view and compared with the left view's own."""

from __future__ import annotations

import torch

from anystereo_tpu_torch.ops.sampling import gather_1d_linear


def warp_disparity(right_map: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Sample `right_map` at x - disp along each row (linear, zeros
    outside).  right_map, disp: [B, H, W] → [B, H, W].  On the card this is
    one launch of `gather_rows_linear` over B·H rows of W positions."""
    xs = torch.arange(disp.shape[-1], dtype=torch.float32, device=disp.device)
    return gather_1d_linear(right_map, xs - disp)


def occ_mask(disp_left: torch.Tensor, disp_right: torch.Tensor, thresh: float = 3.0) -> torch.Tensor:
    """True where occluded: the warped right disparity and the left one
    disagree by more than `thresh` px."""
    return (disp_left - warp_disparity(disp_right, disp_left)).abs() > thresh
