"""Normalized coordinate grids for the implicit decoder.

Twin of `anystereo_tpu/ops/coords.py`: normalized coords live in [-1, 1],
stored in (y, x) order; pixel centers of an axis of length n sit at
-1 + (2i + 1) / n.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def _axis_centers(
    n: int, lo: float = -1.0, hi: float = 1.0, device: Optional[torch.device] = None
) -> torch.Tensor:
    r = (hi - lo) / (2 * n)
    return lo + r + (2 * r) * torch.arange(n, dtype=torch.float32, device=device)


def make_coord(
    shape: Sequence[int],
    ranges: Sequence[Tuple[float, float]] | None = None,
    flatten: bool = True,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Pixel-center coordinate grid: [H*W, 2] (flatten) or [H, W, 2],
    components ordered (y, x)."""
    axes = []
    for i, n in enumerate(shape):
        lo, hi = (-1.0, 1.0) if ranges is None else ranges[i]
        axes.append(_axis_centers(n, lo, hi, device))
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    if flatten:
        grid = grid.reshape(-1, grid.shape[-1])
    return grid
