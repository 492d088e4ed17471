"""Disparity upsampling helpers (twin of `anystereo_tpu/ops/upsample.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 patch extraction with zero padding.

    x: [B, H, W] or [B, H, W, C] → [B, H, W, 9*C]; tap order is kernel
    row-major ((ky,kx) = (-1,-1),(-1,0),...,(1,1)), as F.unfold for C=1."""
    if x.dim() == 3:
        x = x[..., None]
    _, h, w, _ = x.shape
    padded = F.pad(x, (0, 0, 1, 1, 1, 1))
    patches = [padded[:, ky : ky + h, kx : kx + w] for ky in range(3) for kx in range(3)]
    return torch.cat(patches, dim=-1)
