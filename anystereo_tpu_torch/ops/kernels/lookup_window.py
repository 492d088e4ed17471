"""Multi-level windowed tap lookup from per-level window starts: the CUDA
kernels (`csrc/lookup_window.cu`, forward and backward, three layouts) and
their plain PyTorch versions.

Port of the JAX package's `gather_pyramid_window_pm`, `gather_pyramid_window_t`
and `gather_pyramid_window` (`anystereo_tpu/ops/pallas/lookup_kernel.py`) with
their custom VJPs.  All three compute the same function: per level `lvl`,
`i0 = floor(base)`, `f = base - i0` shared by all taps, `s_m = pooled[i0 + m]`
(zero outside `[0, L >> lvl)`; `pooled[c]` = the sum of the row's `2^lvl`
entries from `c·2^lvl`, times `2^-lvl`; the tail `j >= (L >> lvl) << lvl` is
never read) and `out_k = (1 - f)·s_k + f·s_{k+1}`.  Bases are in the level's
pooled units and are not clamped.  They differ in layout:

    gather_pyramid_window_pm  vol_t [L, R], bases_t [levels, R] → [R, levels·taps]
    gather_pyramid_window_t   vol_t [L, R], bases_t [levels, R] → [levels·taps, R]
    gather_pyramid_window     vol [R, L],   bases [R, levels]   → [R, levels·taps]

Everything is fp32; each is differentiable in the volume only.  This is not
the arithmetic of `gather_pyramid_aligned` (which floors every tap's own
position and pools by repeated halving), so the plain versions here follow
the JAX kernel bodies, with the order of every sum fixed (a cell's entries
ascending, levels ascending) so that kernel and plain version agree bit for
bit.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from anystereo_tpu_torch.ops.kernels.gather import _kernel_device

_MAX_LEVELS = 5  # the kernel sums at most 2^(levels-1) = 16 entries a cell
_PM, _T, _ROWS = 0, 1, 2  # the kernel's layout codes


def _entry(name: str):
    """A C entry point of `csrc/lookup_window.cu`, built on first use.
    Forward and backward take the same argument types."""
    from anystereo_tpu_torch.ops.kernels.build import load_library

    fn = getattr(load_library("lookup_window"), name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_pair(a: torch.Tensor, b: torch.Tensor, what: str, taps: int, levels: int):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"expected 2-D {what}, got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"{what} must be float32, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"{what} on {a.device} and {b.device}")
    if taps < 1:
        raise ValueError(f"taps must be positive, got {taps}")
    if not 1 <= levels <= _MAX_LEVELS:
        raise ValueError(f"levels must be in [1, {_MAX_LEVELS}], got {levels}")


# ------------------------------------------------------------ plain versions


def _window_starts(base: torch.Tensor, n: int, taps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(i0 as int64, f) of one level's bases [R].  floor(base) is clamped in
    float to [-(taps+1), n] before the conversion: a window beyond either
    bound has no live tap, so only dead windows move, and positions like 3e9
    stay finite indices."""
    f0 = torch.floor(base)
    return f0.clamp(-(taps + 1), n).long(), base - f0


def _window_rows_ref(vol: torch.Tensor, bases: torch.Tensor, taps: int) -> torch.Tensor:
    """The shared arithmetic on row-major operands: vol [R, L], bases
    [R, levels] → [R, levels·taps]."""
    rows, length = vol.shape
    levels = bases.shape[1]
    m = torch.arange(taps + 1, device=vol.device)
    outs = []
    for lvl in range(levels):
        width, n = 2 ** lvl, length >> lvl
        if n == 0:
            outs.append(vol.new_zeros((rows, taps)))
            continue
        cells = vol[:, : n * width].reshape(rows, n, width)
        pooled = cells[..., 0]
        for t in range(1, width):  # ascending, as the kernel sums
            pooled = pooled + cells[..., t]
        pooled = pooled * (1.0 / width)
        i0, f = _window_starts(bases[:, lvl], n, taps)
        idx = i0[:, None] + m
        live = (idx >= 0) & (idx < n)
        s = torch.where(live, torch.gather(pooled, 1, idx.clamp(0, n - 1)), pooled.new_zeros(()))
        f = f[:, None]
        outs.append((1.0 - f) * s[:, :-1] + f * s[:, 1:])
    return torch.cat(outs, dim=1)


def _window_rows_bwd_ref(bases: torch.Tensor, g: torch.Tensor, length: int, taps: int) -> torch.Tensor:
    """Transpose of `_window_rows_ref` in `vol`: bases [R, levels], g
    [R, levels·taps] → dvol [R, length].  Per level the taps+1 slot
    coefficients c_m = ((1-f)·g_m + f·g_{m-1})·2^-lvl land on the cells
    i0 + m inside the pooled range (one slot a cell), each cell spreads over
    its 2^lvl entries, and the levels are summed in ascending order."""
    rows, levels = bases.shape
    gl = g.reshape(rows, levels, taps)
    m = torch.arange(taps + 1, device=g.device)
    dvol = g.new_zeros((rows, length))
    zero = g.new_zeros((rows, 1))
    for lvl in range(levels):
        width, n = 2 ** lvl, length >> lvl
        if n == 0:
            continue
        i0, f = _window_starts(bases[:, lvl], n, taps)
        f = f[:, None]
        coeff = ((1.0 - f) * torch.cat([gl[:, lvl], zero], 1)
                 + f * torch.cat([zero, gl[:, lvl]], 1)) * (1.0 / width)
        idx = i0[:, None] + m
        live = (idx >= 0) & (idx < n)
        cells = g.new_zeros((rows, n))
        cells.scatter_add_(1, idx.clamp(0, n - 1), torch.where(live, coeff, zero))
        dvol[:, : n * width] += cells.repeat_interleave(width, dim=1)
    return dvol


def gather_pyramid_window_ref(vol: torch.Tensor, bases: torch.Tensor, taps: int) -> torch.Tensor:
    """Plain version of `gather_pyramid_window`."""
    return _window_rows_ref(vol, bases, taps)


def gather_pyramid_window_bwd_ref(bases, g, length: int, taps: int) -> torch.Tensor:
    """Plain version of `gather_pyramid_window`'s backward: dvol [R, length]."""
    return _window_rows_bwd_ref(bases, g, length, taps)


def gather_pyramid_window_t_ref(vol_t: torch.Tensor, bases_t: torch.Tensor, taps: int) -> torch.Tensor:
    """Plain version of `gather_pyramid_window_t`: → [levels·taps, R]."""
    return _window_rows_ref(vol_t.t(), bases_t.t(), taps).t().contiguous()


def gather_pyramid_window_t_bwd_ref(bases_t, g, length: int, taps: int) -> torch.Tensor:
    """g [levels·taps, R] → dvol_t [length, R]."""
    return _window_rows_bwd_ref(bases_t.t(), g.t(), length, taps).t().contiguous()


def gather_pyramid_window_pm_ref(vol_t: torch.Tensor, bases_t: torch.Tensor, taps: int) -> torch.Tensor:
    """Plain version of `gather_pyramid_window_pm`: → [R, levels·taps]."""
    return _window_rows_ref(vol_t.t(), bases_t.t(), taps)


def gather_pyramid_window_pm_bwd_ref(bases_t, g, length: int, taps: int) -> torch.Tensor:
    """g [R, levels·taps] → dvol_t [length, R]."""
    return _window_rows_bwd_ref(bases_t.t(), g, length, taps).t().contiguous()


# ------------------------------------------------------------------ wrappers


def _geometry(layout: int, vol: torch.Tensor, bases: torch.Tensor):
    """(rows, length, levels) of the operands of one layout."""
    if layout == _ROWS:
        (rows, length), (brows, levels) = vol.shape, bases.shape
    else:
        (length, rows), (levels, brows) = vol.shape, bases.shape
    if brows != rows:
        raise ValueError(f"volume {tuple(vol.shape)} and bases {tuple(bases.shape)} disagree on R")
    return rows, length, levels


def _forward(fn, ref, layout: int, vol, bases, taps: int) -> torch.Tensor:
    rows, length, levels = _geometry(layout, vol, bases)
    _check_pair(vol, bases, "volume and bases", taps, levels)
    if not _kernel_device(vol):
        return ref(vol, bases, taps)
    if not (vol.is_contiguous() and bases.is_contiguous()):
        raise ValueError("volume and bases must be contiguous")
    shape = (levels * taps, rows) if layout == _T else (rows, levels * taps)
    out = torch.empty(shape, dtype=torch.float32, device=vol.device)
    with torch.cuda.device(vol.device):
        err = _entry("anystereo_gather_pyramid_window")(
            vol.data_ptr(), bases.data_ptr(), out.data_ptr(), rows, length, taps, levels, layout,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel failed: CUDA error {err}")
    fn.launches += 1
    return out


def _backward(fn, ref, layout: int, bases, g, length: int, taps: int) -> torch.Tensor:
    if bases.dim() != 2:
        raise ValueError(f"expected 2-D bases, got {tuple(bases.shape)}")
    rows, levels = bases.shape if layout == _ROWS else bases.shape[::-1]
    _check_pair(bases, g, "bases and cotangent", taps, levels)
    want = (levels * taps, rows) if layout == _T else (rows, levels * taps)
    if tuple(g.shape) != want or length < 1:
        raise ValueError(f"expected cotangent {want} and length >= 1, got {tuple(g.shape)}, {length}")
    if not _kernel_device(bases):
        return ref(bases, g, length, taps)
    if not (bases.is_contiguous() and g.is_contiguous()):
        raise ValueError("bases and cotangent must be contiguous")
    shape = (rows, length) if layout == _ROWS else (length, rows)
    dvol = torch.empty(shape, dtype=torch.float32, device=bases.device)
    with torch.cuda.device(bases.device):
        err = _entry("anystereo_gather_pyramid_window_bwd")(
            bases.data_ptr(), g.data_ptr(), dvol.data_ptr(), rows, length, taps, levels, layout,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel failed: CUDA error {err}")
    fn.launches += 1
    return dvol


def gather_pyramid_window_pm_bwd(bases_t, g, length: int, taps: int) -> torch.Tensor:
    """Gradient of `gather_pyramid_window_pm` in `vol_t`: bases_t [levels, R],
    g [R, levels·taps] → dvol_t [length, R], all fp32.  Kernel on the card
    (every entry written), plain version on the CPU; counts its launches."""
    return _backward(gather_pyramid_window_pm_bwd, gather_pyramid_window_pm_bwd_ref, _PM,
                     bases_t, g, length, taps)


def gather_pyramid_window_t_bwd(bases_t, g, length: int, taps: int) -> torch.Tensor:
    """As `gather_pyramid_window_pm_bwd` with g [levels·taps, R]."""
    return _backward(gather_pyramid_window_t_bwd, gather_pyramid_window_t_bwd_ref, _T,
                     bases_t, g, length, taps)


def gather_pyramid_window_bwd(bases, g, length: int, taps: int) -> torch.Tensor:
    """Gradient of `gather_pyramid_window` in `vol`: bases [R, levels], g
    [R, levels·taps] → dvol [R, length]."""
    return _backward(gather_pyramid_window_bwd, gather_pyramid_window_bwd_ref, _ROWS,
                     bases, g, length, taps)


def _function(forward, backward, length_axis: int):
    """The `torch.autograd.Function` of one layout: forward and backward are
    its two kernels (or, on the CPU, their plain versions); only the volume
    gets a gradient."""

    class _Window(torch.autograd.Function):
        @staticmethod
        def forward(ctx, vol, bases, taps):
            ctx.save_for_backward(bases)
            ctx.geometry = (vol.shape[length_axis], taps)
            return forward(vol, bases, taps)

        @staticmethod
        def backward(ctx, g):
            (bases,) = ctx.saved_tensors
            return backward(bases, g.contiguous(), *ctx.geometry), None, None

    return _Window


def gather_pyramid_window_pm(vol_t: torch.Tensor, bases_t: torch.Tensor, taps: int) -> torch.Tensor:
    """vol_t [L, R], bases_t [levels, R] → [R, levels·taps] fp32, level-major
    tap blocks per row.  Differentiable in `vol_t`; bases get no gradient.

    A CUDA tensor goes to the kernels and a CPU tensor to the plain versions;
    any other device raises.  Each forward launch adds one to
    `gather_pyramid_window_pm.launches`, each backward launch one to
    `gather_pyramid_window_pm_bwd.launches`."""
    return _WindowPm.apply(vol_t, bases_t, taps)


def gather_pyramid_window_t(vol_t: torch.Tensor, bases_t: torch.Tensor, taps: int) -> torch.Tensor:
    """As `gather_pyramid_window_pm` with the output transposed:
    → [levels·taps, R]."""
    return _WindowT.apply(vol_t, bases_t, taps)


def gather_pyramid_window(vol: torch.Tensor, bases: torch.Tensor, taps: int) -> torch.Tensor:
    """The same lookup on row-major operands: vol [R, L], bases [R, levels]
    → [R, levels·taps]."""
    return _WindowRows.apply(vol, bases, taps)


_WindowPm = _function(
    lambda v, b, k: _forward(gather_pyramid_window_pm, gather_pyramid_window_pm_ref, _PM, v, b, k),
    gather_pyramid_window_pm_bwd, 0)
_WindowT = _function(
    lambda v, b, k: _forward(gather_pyramid_window_t, gather_pyramid_window_t_ref, _T, v, b, k),
    gather_pyramid_window_t_bwd, 0)
_WindowRows = _function(
    lambda v, b, k: _forward(gather_pyramid_window, gather_pyramid_window_ref, _ROWS, v, b, k),
    gather_pyramid_window_bwd, 1)

for _fn in (gather_pyramid_window_pm, gather_pyramid_window_t, gather_pyramid_window,
            gather_pyramid_window_pm_bwd, gather_pyramid_window_t_bwd, gather_pyramid_window_bwd):
    _fn.launches = 0
