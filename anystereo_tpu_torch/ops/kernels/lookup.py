"""Multi-level pooled linear tap lookup: the CUDA kernels
(`csrc/lookup_aligned.cu`, forward and backward) and their plain PyTorch
versions.

Port of the JAX package's `gather_pyramid_aligned_pm` and its custom VJP.
The TPU kernel takes the volume transposed ([L, R], pixels on lanes); on
the card the natural layout is the volume as it lies in memory, `vol [R, L]`
row-major, so the GEV volume [B,H,W,G,D] and the correlation [B,H,W,W2]
are passed as free views, and the gradient comes back in the same layout.
`gather_pyramid_aligned` is differentiable in `vol`; positions get no
gradient.
"""

from __future__ import annotations

import ctypes

import torch

from anystereo_tpu_torch.ops.kernels.lookup_linear import gather_rows_linear_ref
from anystereo_tpu_torch.ops.sampling import pool_half_last

_MAX_LEVELS = 5  # the kernel pools in registers up to 2^(levels-1) = 16 values
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _clamp_bounds(length: int, taps: int, levels: int):
    """Positions at or beyond these bounds give all-zero taps at every
    level, so clamping moves only dead rows (and keeps indices finite)."""
    slack = ((taps - 1) // 2 + 2) * (2 ** levels)
    return float(-slack), float(length + slack)


def _check(vol: torch.Tensor, x: torch.Tensor, taps: int, levels: int, out_dtype):
    if vol.dim() != 2 or x.dim() != 1 or x.shape[0] != vol.shape[0]:
        raise ValueError(f"expected vol [R, L] and x [R], got {tuple(vol.shape)}, {tuple(x.shape)}")
    if vol.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"vol and x must be float32, got {vol.dtype}, {x.dtype}")
    if vol.device != x.device:
        raise ValueError(f"vol on {vol.device}, x on {x.device}")
    if taps < 1 or taps % 2 != 1:
        raise ValueError(f"taps must be odd and positive, got {taps}")
    if not 1 <= levels <= _MAX_LEVELS:
        raise ValueError(f"levels must be in [1, {_MAX_LEVELS}], got {levels}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")


def _kernel(backward: bool = False):
    """A C entry point of `csrc/lookup_aligned.cu`, built on first use.
    Forward and backward take the same argument types."""
    from anystereo_tpu_torch.ops.kernels.build import load_library

    lib = load_library("lookup_aligned")
    fn = lib.anystereo_gather_pyramid_aligned_bwd if backward else lib.anystereo_gather_pyramid_aligned
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_pyramid_aligned_ref(
    vol: torch.Tensor, x: torch.Tensor, taps: int, levels: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version: per level, pool the rows by 2^lvl and linearly
    interpolate taps at x*2^-lvl - radius + k.  vol [R, L], x [R] →
    [R, levels*taps], level-major."""
    radius = (taps - 1) // 2
    lo, hi = _clamp_bounds(vol.shape[-1], taps, levels)
    xc = x.float().clamp(lo, hi)
    k = torch.arange(taps, dtype=torch.float32, device=vol.device)
    lv, outs = vol.float(), []
    for lvl in range(levels):
        base = xc * (2.0 ** -lvl) - radius
        outs.append(gather_rows_linear_ref(lv, base[:, None] + k))
        lv = pool_half_last(lv)
    return torch.cat(outs, dim=-1).to(out_dtype)


def _forward(vol, x, taps, levels, out_dtype):
    """Kernel for a CUDA tensor, plain version for a CPU tensor, no other
    device; counts the launch."""
    _check(vol, x, taps, levels, out_dtype)
    if vol.device.type == "cpu":
        return gather_pyramid_aligned_ref(vol, x, taps, levels, out_dtype)
    if vol.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {vol.device}")
    if not (vol.is_contiguous() and x.is_contiguous()):
        raise ValueError("vol and x must be contiguous")
    rows, length = vol.shape
    out = torch.empty((rows, levels * taps), dtype=out_dtype, device=vol.device)
    with torch.cuda.device(vol.device):
        err = _kernel()(vol.data_ptr(), x.data_ptr(), out.data_ptr(), rows, length, taps,
                        levels, int(out_dtype == torch.bfloat16),
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_pyramid_aligned kernel failed: CUDA error {err}")
    gather_pyramid_aligned.launches += 1
    return out


def gather_pyramid_aligned_bwd_ref(
    x: torch.Tensor, g: torch.Tensor, length: int, taps: int, levels: int
) -> torch.Tensor:
    """Plain version of the backward: the transpose of
    `gather_pyramid_aligned_ref` in `vol`.  x [R], g [R, levels*taps] (any
    float dtype, widened to fp32) → dvol [R, length] fp32.  Per level the
    taps scatter into the pooled row in ascending order (lower cell, then
    upper cell: one cell per row and call, so the order of the sums is
    fixed), and the pooled gradient spreads over the 2^lvl entries of each
    cell, scaled by 2^-lvl; the entries past (L >> lvl) << lvl get nothing."""
    radius = (taps - 1) // 2
    lo, hi = _clamp_bounds(length, taps, levels)
    xc = x.float().clamp(lo, hi)
    gf = g.float().reshape(x.shape[0], levels, taps)
    dvol = torch.zeros((x.shape[0], length), dtype=torch.float32, device=x.device)
    for lvl in range(levels):
        n = length >> lvl
        if n == 0:
            break
        base = xc * (2.0 ** -lvl) - radius
        dl = torch.zeros((x.shape[0], n), dtype=torch.float32, device=x.device)
        for k in range(taps):
            pos = base + float(k)
            x0f = torch.floor(pos)
            w1 = pos - x0f
            i0 = x0f.long()
            for idx, w in ((i0, 1.0 - w1), (i0 + 1, w1)):
                valid = ((idx >= 0) & (idx <= n - 1)).float()
                dl.scatter_add_(1, idx.clamp(0, n - 1)[:, None], (gf[:, lvl, k] * w * valid)[:, None])
        width = 2 ** lvl
        dvol[:, : n * width] += dl.repeat_interleave(width, dim=1) * (1.0 / width)
    return dvol


def gather_pyramid_aligned_bwd(
    x: torch.Tensor, g: torch.Tensor, length: int, taps: int, levels: int
) -> torch.Tensor:
    """Gradient of `gather_pyramid_aligned` in `vol`: x [R] fp32 positions,
    g [R, levels*taps] fp32 or bf16 → dvol [R, length] fp32.

    A CUDA tensor goes to the kernel (which writes every entry of dvol, so
    the output is `torch.empty`), a CPU tensor to the plain version; any
    other device raises.  Each kernel launch adds one to
    `gather_pyramid_aligned_bwd.launches`."""
    if x.dim() != 1 or g.dim() != 2 or g.shape != (x.shape[0], levels * taps):
        raise ValueError(f"expected x [R] and g [R, {levels * taps}], got "
                         f"{tuple(x.shape)}, {tuple(g.shape)}")
    if x.dtype != torch.float32 or g.dtype not in _OUT_DTYPES:
        raise TypeError(f"x must be float32 and g float32 or bfloat16, got {x.dtype}, {g.dtype}")
    if x.device != g.device:
        raise ValueError(f"x on {x.device}, g on {g.device}")
    if taps < 1 or taps % 2 != 1 or not 1 <= levels <= _MAX_LEVELS or length < 1:
        raise ValueError(f"bad taps {taps}, levels {levels} or length {length}")
    if x.device.type == "cpu":
        return gather_pyramid_aligned_bwd_ref(x, g, length, taps, levels)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("x and g must be contiguous")
    rows = x.shape[0]
    dvol = torch.empty((rows, length), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel(backward=True)(x.data_ptr(), g.data_ptr(), dvol.data_ptr(), rows, length,
                                     taps, levels, int(g.dtype == torch.bfloat16),
                                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_pyramid_aligned_bwd kernel failed: CUDA error {err}")
    gather_pyramid_aligned_bwd.launches += 1
    return dvol


gather_pyramid_aligned_bwd.launches = 0


class _GatherPyramidAligned(torch.autograd.Function):
    """Forward and backward are the two kernels (or, on the CPU, their
    plain versions); only `vol` gets a gradient."""

    @staticmethod
    def forward(ctx, vol, x, taps, levels, out_dtype):
        ctx.save_for_backward(x)
        ctx.geometry = (vol.shape[1], taps, levels)
        return _forward(vol, x, taps, levels, out_dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return gather_pyramid_aligned_bwd(x, g.contiguous(), *ctx.geometry), None, None, None, None


def gather_pyramid_aligned(
    vol: torch.Tensor, x: torch.Tensor, taps: int, levels: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Pyramid lookup of `taps` taps at each of `levels` levels from the
    level-0 rows `vol [R, L]` (fp32) at positions `x [R]` (fp32).
    Differentiable in `vol` (the gradient arrives in `out_dtype` and is
    summed in fp32); `x` gets none.

    A CUDA tensor goes to the kernel and a CPU tensor to the plain version;
    any other device raises.  Each forward launch adds one to
    `gather_pyramid_aligned.launches`, each backward launch one to
    `gather_pyramid_aligned_bwd.launches`."""
    return _GatherPyramidAligned.apply(vol, x, taps, levels, out_dtype)


gather_pyramid_aligned.launches = 0
