"""Sampling / interpolation primitives (twin of `anystereo_tpu/ops/sampling.py`).

Public functions keep the JAX package's channels-last layout ([B, H, W, C]);
inside, the pooling ops run on a channels-first view, so a caller that holds
an NCHW tensor and passes `x.permute(0, 2, 3, 1)` pays for no copy.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from anystereo_tpu_torch.ops.kernels.gather import gather_rows, gather_rows_hybrid, gather_rows_ref


def gather_1d_linear(vol: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Linearly interpolate `vol` [..., L] along its last axis at fractional
    `pos` [..., K] (pixel units); taps outside [0, L-1] contribute zero."""
    L = vol.shape[-1]
    x0f = torch.floor(pos)
    w1 = (pos - x0f).to(vol.dtype)
    i0 = x0f.long()
    i1 = i0 + 1
    valid0 = ((i0 >= 0) & (i0 <= L - 1)).to(vol.dtype)
    valid1 = ((i1 >= 0) & (i1 <= L - 1)).to(vol.dtype)
    v0 = torch.gather(vol, -1, i0.clamp(0, L - 1))
    v1 = torch.gather(vol, -1, i1.clamp(0, L - 1))
    return v0 * valid0 * (1.0 - w1) + v1 * valid1 * w1


def _nearest_indices(c: torch.Tensor, n: int) -> torch.Tensor:
    """Normalized coord → nearest pixel index (grid_sample align_corners=
    False unnormalization, round half to even, clamp)."""
    ix = ((c + 1.0) * n - 1.0) * 0.5
    return torch.round(ix).long().clamp(0, n - 1)


# -- query-gather implementation dispatch -- #
GATHER_IMPLS = ("torch", "kernel", "hybrid")
_GATHER_OVERRIDE: Optional[str] = None


def set_gather_override(impl: Optional[str]) -> None:
    """Force the query-gather implementation globally: "torch" (plain
    indexing, autograd's own backward), "kernel" (`gather_rows`: kernel
    forward and backward) or "hybrid" (`gather_rows_hybrid`: plain forward,
    kernel backward); None restores the default dispatch."""
    global _GATHER_OVERRIDE
    if impl is not None and impl not in GATHER_IMPLS:
        raise ValueError(f"gather impl {impl!r}: expected one of {GATHER_IMPLS}")
    _GATHER_OVERRIDE = impl


def _gather_impl(channels: int) -> str:
    if _GATHER_OVERRIDE is not None:
        return _GATHER_OVERRIDE
    env = os.environ.get("ANYSTEREO_GATHER_IMPL")
    if env:
        if env not in GATHER_IMPLS:
            raise ValueError(f"ANYSTEREO_GATHER_IMPL={env!r}: expected one of {GATHER_IMPLS}")
        return env
    # Narrow tables (the 9-tap disparity rows) take the kernel backward, as
    # in the JAX package; wide latent tables keep plain indexing.  The JAX
    # dispatch also asks for a table of at most 6 MB and 4096 rows: those
    # price the TPU kernel's VMEM residency and its Q*N one-hot product,
    # neither of which exists on the card, so they are dropped.  The rule
    # is the same on the CPU, where both kernels are their plain versions.
    return "hybrid" if channels <= 16 else "torch"


def gather_rows_flat(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, q] = flat[b, idx[b, q]], a batched row gather with the
    implementation dispatch above.  flat: [B, N, C]; idx: [B, Q] integer →
    [B, Q, C].  Differentiable in `flat`; duplicate indices sum."""
    impl = _gather_impl(flat.shape[2])
    if impl == "torch":
        return gather_rows_ref(flat, idx)
    fn = gather_rows if impl == "kernel" else gather_rows_hybrid
    return fn(flat.contiguous(), idx.to(torch.int32).contiguous())


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
