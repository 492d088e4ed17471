"""Cost-volume construction and soft-argmin disparity regression (twin of
`anystereo_tpu/ops/cost_volume.py`).

Layout as in the JAX package: feature maps [B, H, W, C]; volumes
[B, H, W, G, D] / [B, H, W, W2] with the searched axis innermost, so a
lookup reads contiguous rows.  The grouped all-pairs products are plain
fp32 matmuls (products of bf16 inputs are exact in fp32).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def all_pairs_correlation(fl: torch.Tensor, fr: torch.Tensor) -> torch.Tensor:
    """corr[b,h,i,j] = <fl[b,h,i,:], fr[b,h,j,:]>, fp32 accumulation.
    fl: [B, H, W1, C], fr: [B, H, W2, C] → [B, H, W1, W2]."""
    return torch.matmul(fl.float(), fr.float().transpose(-1, -2))


def build_gwc_volume(
    fl: torch.Tensor, fr: torch.Tensor, max_disp: int, num_groups: int
) -> torch.Tensor:
    """Group-wise correlation volume by shifting: [B, H, W, G, D] with
    vol[b,h,w,g,d] = mean_c fl[b,h,w,gc] * fr[b,h,w-d,gc], zero where w < d."""
    b, h, w, c = fl.shape
    cg = c // num_groups
    fl_g = fl.reshape(b, h, w, num_groups, cg).float()
    fr_g = fr.reshape(b, h, w, num_groups, cg).float()
    slabs = []
    for d in range(max_disp):
        fr_d = F.pad(fr_g, (0, 0, 0, 0, d, 0))[:, :, :w]
        slabs.append((fl_g * fr_d).mean(dim=-1))
    return torch.stack(slabs, dim=-1)


def _band_from_all_pairs(ap: torch.Tensor, max_disp: int) -> torch.Tensor:
    """band[..., w, d] = ap[..., w, w-d], zero where w < d.  The diagonal
    stride is a re-view at pitch W+1 of the padded flat matrix."""
    *lead, w_rows, w_cols = ap.shape
    assert w_rows == w_cols, "all-pairs matrix must be square"
    d = max_disp
    assert d <= w_rows, "banded extraction needs max_disp <= W"
    flat = ap.reshape(*lead, w_rows * w_rows)
    flat = F.pad(flat, (d - 1, w_rows - d + 1))
    band = flat.reshape(*lead, w_rows, w_rows + 1)[..., :d].flip(-1)
    idx = torch.arange(w_rows, device=ap.device)
    mask = idx[:, None] >= idx[None, :d]
    return torch.where(mask, band, torch.zeros((), dtype=band.dtype, device=band.device))


def build_gwc_and_corr(
    fl: torch.Tensor, fr: torch.Tensor, max_disp: int, num_groups: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GWC volume and all-pairs correlation from one grouped product:
    corr = Σ_g S_g and gwc[..., g, d] = S_g[w, w-d] / (C/G), where
    S_g = fl_g @ fr_g^T.  Returns (gwc [B,H,W,G,D] fp32, corr [B,H,W,W] fp32)."""
    b, h, w, c = fl.shape
    assert c % num_groups == 0
    cg = c // num_groups
    if max_disp > w:
        return (
            build_gwc_volume(fl, fr, max_disp, num_groups),
            all_pairs_correlation(fl, fr),
        )
    fl_g = fl.reshape(b, h, w, num_groups, cg)
    fr_g = fr.reshape(b, h, w, num_groups, cg)
    inv = 1.0 / cg
    corr = None
    bands = []
    for g in range(num_groups):
        ap = all_pairs_correlation(fl_g[..., g, :], fr_g[..., g, :])
        corr = ap if corr is None else corr + ap
        bands.append(_band_from_all_pairs(ap, max_disp) * inv)
    return torch.stack(bands, dim=-2), corr


def disparity_regression(prob: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Soft-argmin expectation Σ_d d·p(d) over the last axis."""
    assert prob.shape[-1] == max_disp
    d_vals = torch.arange(max_disp, dtype=prob.dtype, device=prob.device)
    return torch.sum(prob * d_vals, dim=-1)
