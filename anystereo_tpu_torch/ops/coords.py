"""Normalized coordinate grids for the implicit decoder.

Twin of `anystereo_tpu/ops/coords.py`: normalized coords live in [-1, 1],
stored in (y, x) order; pixel centers of an axis of length n sit at
-1 + (2i + 1) / n.  Inside a spatial context (`parallel/spatial.py`) a
grid's rows are the rank's rows of the frame's grid.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from anystereo_tpu_torch.parallel import spatial


def _axis_centers(
    n: int, lo: float = -1.0, hi: float = 1.0, device: Optional[torch.device] = None,
    rows: bool = False,
) -> torch.Tensor:
    """Centers of n cells over [lo, hi].  `rows`: the axis is the frame's
    rows, of which a rank in a spatial context holds n: the centers of its
    rows in the frame's grid."""
    ctx = spatial.current() if rows else None
    if ctx is None:
        r = (hi - lo) / (2 * n)
        return lo + r + (2 * r) * torch.arange(n, dtype=torch.float32, device=device)
    a0, a1, total = ctx.span(n)
    return _axis_centers(total, lo, hi, device)[a0:a1]


def make_coord(
    shape: Sequence[int],
    ranges: Sequence[Tuple[float, float]] | None = None,
    flatten: bool = True,
    device: Optional[torch.device] = None,
    rows: bool = False,
) -> torch.Tensor:
    """Pixel-center coordinate grid: [H*W, 2] (flatten) or [H, W, 2],
    components ordered (y, x).  `rows`: the first axis is the frame's rows
    (`_axis_centers`)."""
    axes = []
    for i, n in enumerate(shape):
        lo, hi = (-1.0, 1.0) if ranges is None else ranges[i]
        axes.append(_axis_centers(n, lo, hi, device, rows=rows and i == 0))
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    if flatten:
        grid = grid.reshape(-1, grid.shape[-1])
    return grid


def make_coord_grid(h: int, w: int, device: Optional[torch.device] = None) -> torch.Tensor:
    """[2, H, W] coordinate map of latent pixel centers ((y, x) components)."""
    return make_coord((h, w), flatten=False, device=device).permute(2, 0, 1)


def to_pixel_samples(img_hw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten a [H, W] (or [H, W, C]) map into (coords [H*W, 2], values
    [H*W, C]) query pairs."""
    h, w = img_hw.shape[:2]
    coords = make_coord((h, w), flatten=True, device=img_hw.device)
    return coords, img_hw.reshape(h * w, -1)
