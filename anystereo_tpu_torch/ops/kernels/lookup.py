"""Multi-level pooled linear tap lookup: the CUDA kernel
(`csrc/lookup_aligned.cu`) and its plain PyTorch version.

Port of the JAX package's `gather_pyramid_aligned_pm` forward.  The TPU
kernel takes the volume transposed ([L, R], pixels on lanes); on the card
the natural layout is the volume as it lies in memory, `vol [R, L]`
row-major, so the GEV volume [B,H,W,G,D] and the correlation [B,H,W,W2]
are passed as free views.
"""

from __future__ import annotations

import ctypes

import torch

from anystereo_tpu_torch.ops.sampling import gather_1d_linear, pool_half_last

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


def _kernel():
    """The C entry point of `csrc/lookup_aligned.cu`, built on first use."""
    from anystereo_tpu_torch.ops.kernels.build import load_library

    fn = load_library("lookup_aligned").anystereo_gather_pyramid_aligned
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
        outs.append(gather_1d_linear(lv, base[:, None] + k))
        lv = pool_half_last(lv)
    return torch.cat(outs, dim=-1).to(out_dtype)


def gather_pyramid_aligned(
    vol: torch.Tensor, x: torch.Tensor, taps: int, levels: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Pyramid lookup of `taps` taps at each of `levels` levels from the
    level-0 rows `vol [R, L]` (fp32) at positions `x [R]` (fp32).

    A CUDA tensor goes to the kernel and a CPU tensor to the plain version;
    any other device raises.  Each kernel launch adds one to
    `gather_pyramid_aligned.launches`."""
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


gather_pyramid_aligned.launches = 0
