"""Disparity upsampling helpers (twin of `anystereo_tpu/ops/upsample.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from anystereo_tpu_torch.ops.sampling import nearest_resize, nearest_sample
from anystereo_tpu_torch.parallel import spatial


def unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 patch extraction with zero padding.

    x: [B, H, W] or [B, H, W, C] → [B, H, W, 9*C]; tap order is kernel
    row-major ((ky,kx) = (-1,-1),(-1,0),...,(1,1)), as F.unfold for C=1.
    A rank that holds a tile of the rows (`parallel/spatial.py`) pads with
    its neighbours' rows, and zeros only past the frame."""
    if x.dim() == 3:
        x = x[..., None]
    _, h, w, _ = x.shape
    ctx = spatial.current()
    if ctx is None:
        padded = F.pad(x, (0, 0, 1, 1, 1, 1))
    else:
        padded = F.pad(ctx.halo(x, 1, 1, 1), (0, 0, 1, 1))
    patches = [padded[:, ky : ky + h, kx : kx + w] for ky in range(3) for kx in range(3)]
    return torch.cat(patches, dim=-1)


def _clamp_coords(coords: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return coords.clamp(-1.0 + eps, 1.0 - eps)


def context_upsample_queries(
    disp_low: torch.Tensor, weights: torch.Tensor, coords: torch.Tensor
) -> torch.Tensor:
    """Query-based upsampling: the softmaxed decoder weights combine the 3x3
    neighborhood of the low-res cell each query lands in.

    disp_low: [B, H, W] (already scaled by 4*scale); weights: [B, Q, 9];
    coords: [B, Q, 2] normalized (y, x) queries → [B, Q]."""
    patches = unfold3x3(disp_low)  # [B, H, W, 9]
    taps = nearest_sample(patches, _clamp_coords(coords))  # [B, Q, 9]
    return (taps * weights).sum(dim=-1)


def quarter_shifts(h: int, w: int):
    """The four (dy, dx) shifts of the 4-nearest modes: half a latent cell
    in normalized units plus 1e-6, in the order (-,-), (-,+), (+,-), (+,+)."""
    ry, rx, eps = 1.0 / h, 1.0 / w, 1e-6
    return [(vy * ry + eps, vx * rx + eps) for vy in (-1.0, 1.0) for vx in (-1.0, 1.0)]


def context_upsample_queries_quarter(
    disp_low: torch.Tensor, weights: torch.Tensor, coords: torch.Tensor
) -> torch.Tensor:
    """4-nearest variant: the weights combine the four low-res cells at
    coords ± half a cell.  disp_low: [B, H, W]; weights: [B, Q, 4] in the
    order of `quarter_shifts`; coords: [B, Q, 2] → [B, Q]."""
    _, h, w = disp_low.shape
    h = spatial.frame_rows(h)
    taps = [
        nearest_sample(disp_low[..., None], _clamp_coords(coords + coords.new_tensor(shift)))[..., 0]
        for shift in quarter_shifts(h, w)
    ]
    return (torch.stack(taps, dim=-1) * weights).sum(dim=-1)


def context_upsample(disp_low: torch.Tensor, weights: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Fixed-grid upsampling: disp_low [B, H, W] (already scaled), weights
    [B, H', W', 9] → [B, H', W'], each output pixel combining the 3x3
    neighborhood of the low-res cell a nearest resize assigns it.  The
    output grid is the weights' (H' = round(4*H*scale)); `scale` itself does
    not enter the result, as in the JAX package."""
    oh, ow = weights.shape[1], weights.shape[2]
    up = nearest_resize(unfold3x3(disp_low), (oh, ow))  # [B, H', W', 9]
    return (up * weights).sum(dim=-1)
