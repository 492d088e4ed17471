"""Seeded stereo inputs, made on the device in a few large calls.

A scene is a textured plane seen by two rectified cameras: the left view is
a multi-octave noise texture (8-bit levels, as a camera gives them), the
right view the same texture read at x + d(y, x), where d is a piecewise
planar disparity (a few planes over a Voronoi partition of the frame)
inside [d_min, d_max] pixels.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

OCTAVES = (2, 4, 8, 16, 32, 64)  # texture cell sizes in pixels
PLANES = 8  # Voronoi cells of the disparity field


def _texture(n: int, h: int, w: int, gen: torch.Generator, device) -> torch.Tensor:
    """[n, 3, h, w] in 0..255, integer levels."""
    tex = torch.zeros((n, 3, h, w), device=device)
    for s in OCTAVES:
        noise = torch.randn((n, 3, -(-h // s) + 1, -(-w // s) + 1), generator=gen, device=device)
        tex += (s ** 0.5) * F.interpolate(noise, size=(h, w), mode="bilinear", align_corners=False)
    lo = tex.amin(dim=(1, 2, 3), keepdim=True)
    hi = tex.amax(dim=(1, 2, 3), keepdim=True)
    return torch.round(255.0 * (tex - lo) / (hi - lo))


def _disparity(n: int, h: int, w: int, d_min: float, d_max: float, gen: torch.Generator,
               device) -> torch.Tensor:
    """[n, h, w] piecewise planar disparity in [d_min, d_max]."""
    u = torch.rand((n, PLANES, 5), generator=gen, device=device)
    cy, cx = u[..., 0], u[..., 1]  # cell centres, as fractions of the frame
    a = d_min + (d_max - d_min) * u[..., 2]  # disparity at the centre
    gy, gx = (0.5 * (d_max - d_min) * (u[..., k] - 0.5) for k in (3, 4))  # slope over the frame
    ys = (torch.arange(h, device=device, dtype=torch.float32) + 0.5) / h
    xs = (torch.arange(w, device=device, dtype=torch.float32) + 0.5) / w
    dy = ys[None, None, :, None] - cy[..., None, None]  # [n, P, h, 1]
    dx = xs[None, None, None, :] - cx[..., None, None]  # [n, P, 1, w]
    cell = (dy * dy * (h / w) ** 2 + dx * dx).argmin(dim=1, keepdim=True)  # [n, 1, h, w]
    plane = a[..., None, None] + gy[..., None, None] * dy + gx[..., None, None] * dx
    return torch.gather(plane, 1, cell)[:, 0].clamp(d_min, d_max)


def stereo_pairs(n: int, h: int, w: int, d_min: float, d_max: float, seed: int,
                 device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(left, right, disparity): [n, h, w, 3] float32 views in 0..255 and
    the [n, h, w] disparity of the left view, from `seed`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    pad = int(d_max) + 2
    tex = _texture(n, h, w + pad, gen, device)
    disp = _disparity(n, h, w, d_min, d_max, gen, device)
    # the right view at column x shows the texture at x + d
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, None] + disp
    gx = 2.0 * xs / (w + pad - 1) - 1.0
    gy = (2.0 * torch.arange(h, device=device, dtype=torch.float32) / (h - 1) - 1.0)[None, :, None]
    grid = torch.stack([gx, gy.expand_as(gx)], dim=-1)
    right = torch.round(F.grid_sample(tex, grid, mode="bilinear", align_corners=True))
    left = tex[..., :w]
    return left.permute(0, 2, 3, 1).contiguous(), right.permute(0, 2, 3, 1).contiguous(), disp
