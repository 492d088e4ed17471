"""Correlation / geometry-volume pyramid lookup: the per-iteration gather
that feeds the ConvGRU motion encoder (twin of `anystereo_tpu/ops/lookup.py`).

Three flavors, the three ways the JAX package computes the lookup
(`ANYSTEREO_LOOKUP_KERNEL`, or `pyramid_lookup(kernel=...)`): "aligned"
(default) goes through `gather_pyramid_aligned` on the level-0 rows as they
lie in memory; "classify" builds the per-level window starts and goes
through `gather_pyramid_window_pm` on the transposed volumes ([L, R]);
"levels" (the JAX `impl="jnp"` branch, the reference's own structure) reads
a stored pyramid of pooled levels, one `gather_window_linear` per level and
volume.  The first two pool the levels from the level-0 rows themselves;
the transposed copies and the pooled levels are made by `CorrPyramid` once
per forward.  Every flavor runs its CUDA kernel for a tensor on the card and
the plain PyTorch version for one on the CPU.

Channel order (the JAX package's internal order, which convc1's weights
are bound to): all GEV taps group-major ([G, levels, K] flattened), then
the init-corr taps ([levels, K] flattened).  RAFT mode has no GEV.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from anystereo_tpu_torch.ops.kernels.lookup import gather_pyramid_aligned
from anystereo_tpu_torch.ops.kernels.lookup_linear import gather_window_linear
from anystereo_tpu_torch.ops.kernels.lookup_window import gather_pyramid_window_pm
from anystereo_tpu_torch.ops.sampling import pool_half_last

LOOKUP_KERNELS = ("aligned", "classify", "levels")


def default_lookup_kernel() -> str:
    """The process-level flavor: `ANYSTEREO_LOOKUP_KERNEL`, else "aligned"."""
    return os.environ.get("ANYSTEREO_LOOKUP_KERNEL", "aligned")


@dataclasses.dataclass
class CorrPyramid:
    """The level-0 rows of the lookup pyramids.  The "aligned" and
    "classify" flavors never store the coarser levels (their kernels pool
    them from these rows); the "levels" flavor asks for them (`levels`).

    corr: [B, H, W, W2] all-pairs correlation rows (fp32, contiguous);
    geo: [B, H, W, G, D] geometry volume (fp32, contiguous), or None for
    the RAFT core."""

    corr: torch.Tensor
    geo: Optional[torch.Tensor]
    num_levels: int
    radius: int
    _transposed: dict = dataclasses.field(default_factory=dict, repr=False)
    _levels: dict = dataclasses.field(default_factory=dict, repr=False)

    def transposed(self, name: str) -> torch.Tensor:
        """The volume `name` ("corr" or "geo") as [L, R], contiguous: the
        layout of the "classify" flavor.  The JAX package transposes inside
        every lookup and leaves it to XLA to hoist the copy out of the
        iteration scan; eager PyTorch hoists nothing, so the copy is made at
        the first lookup of a forward and kept (37.4 MB for the all-pairs
        volume at 384x1248).  It is a differentiable function of the volume,
        so the lookups' gradients sum into it and cross back once."""
        t = self._transposed.get(name)
        if t is None:
            vol = getattr(self, name)
            t = vol.reshape(-1, vol.shape[-1]).t().contiguous()
            self._transposed[name] = t
        return t

    def levels(self, name: str) -> tuple:
        """The pooled levels of the volume `name` ("corr" or "geo") as rows
        ([R, L >> lvl], contiguous), level 0 first: the stored pyramid of the
        "levels" flavor, each level `pool_half_last` of the one before.  Made
        at the first lookup of a forward and kept, as `transposed` is, and a
        differentiable function of the volume: the lookups' gradients sum
        into each level and cross back through the pooling once."""
        lv = self._levels.get(name)
        if lv is None:
            vol = getattr(self, name)
            rows = [vol.reshape(-1, vol.shape[-1])]
            for _ in range(self.num_levels - 1):
                rows.append(pool_half_last(rows[-1]))
            lv = self._levels[name] = tuple(rows)
        return lv

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
    kernel: Optional[str] = None,
):
    """Sample 2r+1 taps around the current disparity at every level.

    disp: [B, H, W] current disparity (fp32).  coords: [B, H, W] or [W]
    x-coordinate of each column (default arange(W)).  split: return the
    parts as a tuple ((geo, corr) for IGEV, (corr,) for RAFT) instead of
    concatenating.  out_dtype: dtype of the result (the math is fp32 and
    rounds only at the store); None = fp32.  kernel: one of
    `LOOKUP_KERNELS`; None = `default_lookup_kernel()`.
    Returns [B, H, W, C_lookup] or the split tuple.

    Tap positions: GEV x = disp, corr x = coords - disp, at level i taps
    sit at x / 2^i - r + k for k = 0..2r.  "aligned" clamps x to where the
    last live window ends; "classify" and "levels" do not, and a window far
    outside its row gives exact zeros.
    """
    b, h, w = disp.shape
    r = pyr.radius
    k = 2 * r + 1
    n_lvl = pyr.num_levels
    out_dtype = out_dtype or torch.float32
    kernel = default_lookup_kernel() if kernel is None else kernel
    if kernel not in LOOKUP_KERNELS:
        raise ValueError(f"lookup kernel {kernel!r}: expected one of {LOOKUP_KERNELS}")
    disp = disp.float()
    if coords is None:
        coords = torch.arange(w, dtype=torch.float32, device=disp.device)
    coords = torch.broadcast_to(coords, (b, h, w)).float()
    g = None if pyr.geo is None else pyr.geo.shape[-2]  # [B, H, W, G, D]
    out = []
    if kernel == "aligned":
        if g is not None:
            x_g = disp[..., None].expand(b, h, w, g).reshape(-1)
            out.append(gather_pyramid_aligned(
                pyr.geo.reshape(-1, pyr.geo.shape[-1]), x_g, k, n_lvl, out_dtype
            ))  # [B*H*W*G, levels*K], rows (pixel, g)-major
        out.append(gather_pyramid_aligned(
            pyr.corr.reshape(-1, pyr.corr.shape[-1]),
            (coords - disp).reshape(-1).contiguous(), k, n_lvl, out_dtype,
        ))
    elif kernel == "levels":
        # one launch per level and volume on the stored pooled level; the
        # GEV taps stack as [G, levels, K], the corr taps level-major
        if g is not None:
            taps = [gather_window_linear(
                lv, (disp * 2.0 ** -i - r)[..., None].expand(b, h, w, g).reshape(-1), k)
                for i, lv in enumerate(pyr.levels("geo"))]  # each [B*H*W*G, K]
            out.append(torch.stack(taps, dim=1).to(out_dtype))
        cx = coords - disp
        out.append(torch.cat([gather_window_linear(lv, (cx * 2.0 ** -i - r).reshape(-1), k)
                              for i, lv in enumerate(pyr.levels("corr"))], dim=1).to(out_dtype))
    else:
        # window starts per level, in that level's pooled units, levels first
        # ([levels, R]); the kernel writes fp32 and the cast follows it
        scales = torch.tensor([2.0 ** -i for i in range(n_lvl)], dtype=torch.float32,
                              device=disp.device).reshape(n_lvl, 1, 1, 1)
        if g is not None:
            bases_g = (disp[None] * scales - r)[..., None].expand(n_lvl, b, h, w, g)
            out.append(gather_pyramid_window_pm(
                pyr.transposed("geo"), bases_g.reshape(n_lvl, -1).contiguous(), k).to(out_dtype))
        cbases = ((coords - disp)[None] * scales - r).reshape(n_lvl, -1)
        out.append(gather_pyramid_window_pm(pyr.transposed("corr"), cbases, k).to(out_dtype))
    out = [o.reshape(b, h, w, -1) for o in out]
    if split:
        return tuple(out)
    return torch.cat(out, dim=-1) if len(out) > 1 else out[0]


def lookup_channels(num_levels: int, radius: int, groups: Optional[int]) -> int:
    taps = 2 * radius + 1
    if groups is not None:
        return num_levels * taps * (groups + 1)
    return num_levels * taps


def internal_to_reference_perm(num_levels: int, radius: int, groups: Optional[int]) -> np.ndarray:
    """Index map from the port's lookup channel order to the reference's.

    perm[i] = reference channel index of internal channel i, so
    `out_internal[..., c] == out_reference[..., perm[c]]`, and a reference
    convc1 kernel converts as `kernel_hwio[:, :, perm, :]` (the converter
    gathers the reference's input channels into internal positions).
    Internal: geo [G, levels, K] flattened, then corr [levels, K].
    Reference: per level, geo [G, K] then corr [K].  The identity when
    `groups` is None (RAFT: both orders are [levels, K])."""
    k = 2 * radius + 1
    if groups is None:
        return np.arange(num_levels * k)
    perm = np.empty(num_levels * k * (groups + 1), np.int64)
    i = 0
    for g in range(groups):
        for lvl in range(num_levels):
            for kk in range(k):
                perm[i] = lvl * (groups + 1) * k + g * k + kk
                i += 1
    for lvl in range(num_levels):
        for kk in range(k):
            perm[i] = lvl * (groups + 1) * k + groups * k + kk
            i += 1
    return perm
