"""Correlation / geometry-volume pyramid lookup: the per-iteration gather
that feeds the ConvGRU motion encoder (twin of `anystereo_tpu/ops/lookup.py`).

Every call goes through `gather_pyramid_aligned`, which pools the levels
from the level-0 rows itself: the CUDA kernel for a tensor on the card, the
plain PyTorch version for one on the CPU.

Channel order (the JAX package's internal order, which convc1's weights
are bound to): all GEV taps group-major ([G, levels, K] flattened), then
the init-corr taps ([levels, K] flattened).  RAFT mode has no GEV.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from anystereo_tpu_torch.ops.kernels.lookup import gather_pyramid_aligned


@dataclasses.dataclass
class CorrPyramid:
    """The level-0 rows of the lookup pyramids.  The coarser levels are
    never stored: `gather_pyramid_aligned` pools them from these rows.

    corr: [B, H, W, W2] all-pairs correlation rows (fp32, contiguous);
    geo: [B, H, W, G, D] geometry volume (fp32, contiguous), or None for
    the RAFT core."""

    corr: torch.Tensor
    geo: Optional[torch.Tensor]
    num_levels: int
    radius: int

    @property
    def out_channels(self) -> int:
        g = None if self.geo is None else self.geo.shape[-2]
        return lookup_channels(self.num_levels, self.radius, g)


def build_pyramid(
    corr: torch.Tensor,
    geo_volume: Optional[torch.Tensor],
    num_levels: int,
    radius: int,
) -> CorrPyramid:
    """Lookup pyramids of `num_levels` levels, each halving the last axis
    (floor), held as their level-0 rows in fp32, the layout the kernel reads."""
    geo = None if geo_volume is None else geo_volume.float().contiguous()
    return CorrPyramid(corr.float().contiguous(), geo, num_levels, radius)


def pyramid_lookup(
    pyr: CorrPyramid,
    disp: torch.Tensor,
    coords: Optional[torch.Tensor] = None,
    split: bool = False,
    out_dtype: Optional[torch.dtype] = None,
):
    """Sample 2r+1 taps around the current disparity at every level.

    disp: [B, H, W] current disparity (fp32).  coords: [B, H, W] or [W]
    x-coordinate of each column (default arange(W)).  split: return the
    parts as a tuple ((geo, corr) for IGEV, (corr,) for RAFT) instead of
    concatenating.  out_dtype: dtype of the result (the math is fp32 and
    rounds only at the store); None = fp32.
    Returns [B, H, W, C_lookup] or the split tuple.

    Tap positions: GEV x = disp, corr x = coords - disp, at level i taps
    sit at x / 2^i - r + k for k = 0..2r.
    """
    b, h, w = disp.shape
    k = 2 * pyr.radius + 1
    n_lvl = pyr.num_levels
    out_dtype = out_dtype or torch.float32
    disp = disp.float()
    if coords is None:
        coords = torch.arange(w, dtype=torch.float32, device=disp.device)
    coords = torch.broadcast_to(coords, (b, h, w)).float()
    out = []
    if pyr.geo is not None:
        g = pyr.geo.shape[-2]  # [B, H, W, G, D]
        x_g = disp[..., None].expand(b, h, w, g).reshape(-1)
        geo = gather_pyramid_aligned(
            pyr.geo.reshape(-1, pyr.geo.shape[-1]), x_g, k, n_lvl, out_dtype
        )  # [B*H*W*G, levels*K], rows (pixel, g)-major
        out.append(geo.reshape(b, h, w, g * n_lvl * k))
    corr = gather_pyramid_aligned(
        pyr.corr.reshape(-1, pyr.corr.shape[-1]),
        (coords - disp).reshape(-1).contiguous(), k, n_lvl, out_dtype,
    )
    out.append(corr.reshape(b, h, w, n_lvl * k))
    if split:
        return tuple(out)
    return torch.cat(out, dim=-1) if len(out) > 1 else out[0]


def lookup_channels(num_levels: int, radius: int, groups: Optional[int]) -> int:
    taps = 2 * radius + 1
    if groups is not None:
        return num_levels * taps * (groups + 1)
    return num_levels * taps
