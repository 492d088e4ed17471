"""Sampling / interpolation primitives (twin of `anystereo_tpu/ops/sampling.py`).

Public functions keep the JAX package's channels-last layout ([B, H, W, C]);
inside, the pooling ops run on a channels-first view, so a caller that holds
an NCHW tensor and passes `x.permute(0, 2, 3, 1)` pays for no copy.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from anystereo_tpu_torch.ops.kernels.gather import gather_rows, gather_rows_ref
from anystereo_tpu_torch.ops.kernels.lookup_linear import gather_rows_linear, gather_rows_linear_ref


def gather_1d_linear(vol: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Linearly interpolate `vol` [..., L] along its last axis at fractional
    `pos` [..., K] (pixel units; the leading axes of the two are equal);
    taps outside [0, L-1] contribute zero.  Differentiable in `vol` only:
    the JAX function of the same name is also differentiable in `pos`
    (through the weight `pos - floor(pos)`), the kernel is not, so a `pos`
    that asks for a gradient is refused rather than given zeros.

    A volume on the card goes through `gather_rows_linear` with the leading
    axes flattened to rows (kernel forward, kernel backward, fp32); a volume
    on the CPU through the plain version."""
    if pos.requires_grad and torch.is_grad_enabled():
        raise ValueError("gather_1d_linear gives no gradient to `pos`; detach it")
    if vol.device.type == "cpu":
        return gather_rows_linear_ref(vol, pos)
    if vol.shape[:-1] != pos.shape[:-1]:
        raise ValueError(f"leading axes differ: {tuple(vol.shape)}, {tuple(pos.shape)}")
    out = gather_rows_linear(vol.float().reshape(-1, vol.shape[-1]).contiguous(),
                             pos.float().reshape(-1, pos.shape[-1]).contiguous())
    return out.reshape(pos.shape).to(vol.dtype)


def _nearest_indices(c: torch.Tensor, n: int) -> torch.Tensor:
    """Normalized coord → nearest pixel index (grid_sample align_corners=
    False unnormalization, round half to even, clamp)."""
    ix = ((c + 1.0) * n - 1.0) * 0.5
    return torch.round(ix).long().clamp(0, n - 1)


# -- the query gather: one path on the card, one on the CPU -- #
_GATHER_PLAIN = False


def set_gather_plain(plain: bool) -> None:
    """Force `gather_rows_flat` to the plain version (advanced indexing under
    PyTorch's own autograd) on every device, or restore the rule below.  For
    tests and all-plain reference runs only; no main path sets it."""
    global _GATHER_PLAIN
    _GATHER_PLAIN = bool(plain)


def gather_rows_flat(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, q] = flat[b, idx[b, q]], a batched row gather.  flat:
    [B, N, C]; idx: [B, Q] integer → [B, Q, C].  Differentiable in `flat`;
    duplicate indices sum.

    A table on the card goes through `gather_rows` whatever its width
    (kernel forward, scatter-add kernel backward); a table on the CPU
    through the plain version."""
    if _GATHER_PLAIN or flat.device.type == "cpu":
        return gather_rows_ref(flat, idx)
    return gather_rows(flat.contiguous(), idx.to(torch.int32).contiguous())


def nearest_sample(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor sample of a [B, H, W, C] map at normalized (y, x)
    queries `coords` [B, Q, 2] in [-1, 1] → [B, Q, C]."""
    b, h, w, c = feat.shape
    iy = _nearest_indices(coords[..., 0], h)  # [B, Q]
    ix = _nearest_indices(coords[..., 1], w)
    return gather_rows_flat(feat.reshape(b, h * w, c), iy * w + ix)


def nearest_latent_coords(coords: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Normalized pixel-center coordinates of the latent cell each query
    lands in ([B, Q, 2], (y, x)), in closed form."""
    iy = _nearest_indices(coords[..., 0], h)
    ix = _nearest_indices(coords[..., 1], w)
    qy = -1.0 + (2.0 * iy.to(coords.dtype) + 1.0) / h
    qx = -1.0 + (2.0 * ix.to(coords.dtype) + 1.0) / w
    return torch.stack([qy, qx], dim=-1)


def nearest_dense_gather(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """Separable nearest gather of a dense map at normalized axis grids.

    x: [B, h, w, C]; ys: [H'] / xs: [W'] in [-1, 1]
    returns (out [B, H', W', C], iy [H'], ix [W']).  An index_select gives
    exactly the one-hot contraction of the JAX twin."""
    h, w = x.shape[1], x.shape[2]
    iy = _nearest_indices(ys.clamp(-1 + 1e-6, 1 - 1e-6), h)
    ix = _nearest_indices(xs.clamp(-1 + 1e-6, 1 - 1e-6), w)
    out = x.index_select(1, iy).index_select(2, ix)
    return out, iy, ix


def _linear_resize_matrix(n_in: int, n_out: int, dtype, device) -> torch.Tensor:
    """[n_out, n_in] row-stochastic 1-D linear interpolation matrix with
    align_corners=True endpoints."""
    if n_out == 1:
        pos = torch.zeros((1,), dtype=torch.float32, device=device)
    else:
        pos = torch.arange(n_out, dtype=torch.float32, device=device) * (
            (n_in - 1) / (n_out - 1)
        )
    i0 = torch.floor(pos).long().clamp(0, max(n_in - 2, 0))
    frac = pos - i0.float()
    lo = F.one_hot(i0, n_in).float()
    hi = F.one_hot((i0 + 1).clamp(max=n_in - 1), n_in).float()
    return ((1.0 - frac)[:, None] * lo + frac[:, None] * hi).to(dtype)


def interp_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear align_corners=True resize of [B, H, W, C] as two small
    matmuls (the resize matrices take x's dtype, as in the JAX twin)."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    mh = _linear_resize_matrix(h, oh, x.dtype, x.device)
    mw = _linear_resize_matrix(w, ow, x.dtype, x.device)
    y = torch.einsum("oh,bhwc->bowc", mh, x)
    return torch.einsum("pw,bowc->bopc", mw, y)


def nearest_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of [B, H, W, C] (F.interpolate mode='nearest')."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    iy = torch.floor(torch.arange(oh, device=x.device) * (h / oh)).long()
    ix = torch.floor(torch.arange(ow, device=x.device) * (w / ow)).long()
    return x.index_select(1, iy).index_select(2, ix)


def avg_pool2d(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """F.avg_pool2d on [B, H, W, C] with count_include_pad=True."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
    return y.permute(0, 2, 3, 1)


def pool_half_last(x: torch.Tensor) -> torch.Tensor:
    """Average pool by 2 along the last axis; an odd trailing element is
    dropped (floor semantics)."""
    L2 = x.shape[-1] // 2
    x = x[..., : 2 * L2]
    return x.reshape(*x.shape[:-1], L2, 2).mean(dim=-1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d(1) on [B, H, W, C] → [B, 1, 1, C]."""
    return x.mean(dim=(1, 2), keepdim=True)
