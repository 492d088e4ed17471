"""Single-level linear tap lookups on row-major volumes: the CUDA kernels
(`csrc/lookup_linear.cu`, forward and backward) and their plain PyTorch
versions.

Port of the JAX package's `gather_rows_linear` and `gather_window_linear`
(`anystereo_tpu/ops/pallas/lookup_kernel.py`) with their custom VJPs:

    gather_rows_linear    vol [R, L], pos [R, K]     → [R, K]
        out[r, k] = lerp(vol[r], pos[r, k]) at arbitrary positions
    gather_window_linear  vol [R, L], base [R], taps → [R, taps]
        out[r, k] = lerp(vol[r], base[r] + k), one `floor` and one weight a row

A tap at p reads `i0 = floor(p)` and `i0 + 1` with the weights `1 - w` and
`w = p - i0`; an entry outside [0, L) counts as zero, each neighbour on its
own.  Everything is fp32; each function is differentiable in the volume
only.  The plain versions fix the order of every sum (the rows backward adds
a row's taps in ascending k), and the kernels repeat them operation for
operation, so kernel and plain version agree bit for bit.  `floor(p)` is
clamped in float before the conversion to an integer (to [-2, L], the window
start to [-(taps+1), L]): that moves only taps with no live entry, and
positions like 3e9 stay finite indices.
"""

from __future__ import annotations

import ctypes

import torch

from anystereo_tpu_torch.ops.kernels.gather import _kernel_device


def _entry(name: str):
    """A C entry point of `csrc/lookup_linear.cu`, built on first use.  All
    four take the same argument types."""
    from anystereo_tpu_torch.ops.kernels.build import load_library

    fn = getattr(load_library("lookup_linear"), name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(fn, name: str, a, b, out, rows: int, length: int, taps: int) -> torch.Tensor:
    with torch.cuda.device(out.device):
        err = _entry(name)(a.data_ptr(), b.data_ptr(), out.data_ptr(), rows, length, taps,
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel failed: CUDA error {err}")
    fn.launches += 1
    return out


def _check_pair(a: torch.Tensor, b: torch.Tensor, what: str):
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"{what} must be float32, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"{what} on {a.device} and {b.device}")


def _contiguous(a: torch.Tensor, b: torch.Tensor, what: str):
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what} must be contiguous")


# ---------------------------------------------------------- arbitrary positions


def _tap_index(pos: torch.Tensor, length: int):
    """(i0 as int64, w) of positions of any shape."""
    f0 = torch.floor(pos)
    return f0.clamp(-2, length).long(), pos - f0


def gather_rows_linear_ref(vol: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Plain version of `gather_rows_linear`; takes any equal leading axes:
    vol [..., L], pos [..., K] → [..., K]."""
    length = vol.shape[-1]
    i0, w = _tap_index(pos, length)
    i1 = i0 + 1
    zero = vol.new_zeros(())
    v0 = torch.where((i0 >= 0) & (i0 < length), torch.gather(vol, -1, i0.clamp(0, length - 1)), zero)
    v1 = torch.where((i1 >= 0) & (i1 < length), torch.gather(vol, -1, i1.clamp(0, length - 1)), zero)
    w = w.to(vol.dtype)
    return v0 * (1.0 - w) + v1 * w


def gather_rows_linear_bwd_ref(pos: torch.Tensor, g: torch.Tensor, length: int) -> torch.Tensor:
    """Plain version of the backward: pos [R, K], g [R, K] → dvol [R, length].
    The taps are added one k at a time in ascending order (a tap lands on at
    most one of an entry's two halves), so colliding taps sum in a fixed
    order on every device."""
    rows, taps = pos.shape
    i0, w = _tap_index(pos, length)
    lower, upper = g * (1.0 - w), g * w
    cols = torch.arange(length, device=pos.device)
    zero = g.new_zeros(())
    dvol = g.new_zeros((rows, length))
    for k in range(taps):
        d = cols - i0[:, k:k + 1]
        dvol = dvol + torch.where(d == 0, lower[:, k:k + 1],
                                  torch.where(d == 1, upper[:, k:k + 1], zero))
    return dvol


def _check_rows(vol_shape, pos: torch.Tensor):
    if len(vol_shape) != 2 or pos.dim() != 2 or pos.shape[0] != vol_shape[0]:
        raise ValueError(f"expected [R, L] and positions [R, K], got {tuple(vol_shape)}, "
                         f"{tuple(pos.shape)}")
    if vol_shape[1] < 1 or pos.shape[1] < 1:
        raise ValueError(f"L and K must be positive, got {vol_shape[1]}, {pos.shape[1]}")


def _rows_forward(vol: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    _check_rows(vol.shape, pos)
    _check_pair(vol, pos, "volume and positions")
    if not _kernel_device(vol):
        return gather_rows_linear_ref(vol, pos)
    _contiguous(vol, pos, "volume and positions")
    out = torch.empty(pos.shape, dtype=torch.float32, device=vol.device)
    return _launch(gather_rows_linear, "anystereo_gather_rows_linear", vol, pos, out,
                   vol.shape[0], vol.shape[1], pos.shape[1])


def gather_rows_linear_bwd(pos: torch.Tensor, g: torch.Tensor, length: int) -> torch.Tensor:
    """Gradient of `gather_rows_linear` in `vol`: pos [R, K], g [R, K] →
    dvol [R, length], all fp32; taps that share an entry sum, in ascending k.
    Kernel on the card (no atomics, every entry written), plain version on
    the CPU; counts its launches."""
    _check_rows((pos.shape[0], length), pos)
    if g.shape != pos.shape:
        raise ValueError(f"cotangent {tuple(g.shape)} and positions {tuple(pos.shape)} disagree")
    _check_pair(pos, g, "positions and cotangent")
    if not _kernel_device(pos):
        return gather_rows_linear_bwd_ref(pos, g, length)
    _contiguous(pos, g, "positions and cotangent")
    dvol = torch.empty((pos.shape[0], length), dtype=torch.float32, device=pos.device)
    return _launch(gather_rows_linear_bwd, "anystereo_gather_rows_linear_bwd", pos, g, dvol,
                   pos.shape[0], length, pos.shape[1])


class _RowsLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vol, pos):
        ctx.save_for_backward(pos)
        ctx.length = vol.shape[1]
        return _rows_forward(vol, pos)

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        return gather_rows_linear_bwd(pos, g.contiguous(), ctx.length), None


def gather_rows_linear(vol: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """out[r, k] = lerp(vol[r], pos[r, k]), zero outside [0, L-1]: vol [R, L],
    pos [R, K] → [R, K], fp32.  Differentiable in `vol`; positions get no
    gradient.

    A CUDA tensor goes to the kernels and a CPU tensor to the plain versions;
    any other device raises.  Each forward launch adds one to
    `gather_rows_linear.launches`, each backward launch one to
    `gather_rows_linear_bwd.launches`."""
    return _RowsLinear.apply(vol, pos)


# ------------------------------------------------- a window from one start a row


def _window_start(base: torch.Tensor, length: int, taps: int):
    f0 = torch.floor(base)
    return f0.clamp(-(taps + 1), length).long(), base - f0


def gather_window_linear_ref(vol: torch.Tensor, base: torch.Tensor, taps: int) -> torch.Tensor:
    """Plain version of `gather_window_linear`: the taps+1 entries from
    `floor(base)`, then out_k = (1 - f)·s_k + f·s_{k+1}."""
    length = vol.shape[1]
    i0, f = _window_start(base, length, taps)
    idx = i0[:, None] + torch.arange(taps + 1, device=vol.device)
    live = (idx >= 0) & (idx < length)
    s = torch.where(live, torch.gather(vol, 1, idx.clamp(0, length - 1)), vol.new_zeros(()))
    f = f[:, None]
    return (1.0 - f) * s[:, :-1] + f * s[:, 1:]


def gather_window_linear_bwd_ref(base: torch.Tensor, g: torch.Tensor, length: int,
                                 taps: int) -> torch.Tensor:
    """Plain version of the backward: base [R], g [R, taps] → dvol
    [R, length].  Entry l of a row is slot j = l - i0 of its window and gets
    the one coefficient (1 - f)·g_j + f·g_{j-1} (terms with a tap index
    outside [0, taps) absent), or zero outside the window."""
    i0, f = _window_start(base, length, taps)
    f = f[:, None]
    zero = g.new_zeros((g.shape[0], 1))
    coeff = (1.0 - f) * torch.cat([g, zero], 1) + f * torch.cat([zero, g], 1)
    j = torch.arange(length, device=g.device) - i0[:, None]
    live = (j >= 0) & (j <= taps)
    return torch.where(live, torch.gather(coeff, 1, j.clamp(0, taps)), g.new_zeros(()))


def _check_window(vol_shape, base: torch.Tensor, taps: int):
    if len(vol_shape) != 2 or base.dim() != 1 or base.shape[0] != vol_shape[0]:
        raise ValueError(f"expected [R, L] and window starts [R], got {tuple(vol_shape)}, "
                         f"{tuple(base.shape)}")
    if vol_shape[1] < 1 or taps < 1:
        raise ValueError(f"L and taps must be positive, got {vol_shape[1]}, {taps}")


def _window_forward(vol: torch.Tensor, base: torch.Tensor, taps: int) -> torch.Tensor:
    _check_window(vol.shape, base, taps)
    _check_pair(vol, base, "volume and window starts")
    if not _kernel_device(vol):
        return gather_window_linear_ref(vol, base, taps)
    _contiguous(vol, base, "volume and window starts")
    out = torch.empty((vol.shape[0], taps), dtype=torch.float32, device=vol.device)
    return _launch(gather_window_linear, "anystereo_gather_window_linear", vol, base, out,
                   vol.shape[0], vol.shape[1], taps)


def gather_window_linear_bwd(base: torch.Tensor, g: torch.Tensor, length: int,
                             taps: int) -> torch.Tensor:
    """Gradient of `gather_window_linear` in `vol`: base [R], g [R, taps] →
    dvol [R, length], all fp32.  Kernel on the card (every entry written),
    plain version on the CPU; counts its launches."""
    _check_window((base.shape[0], length), base, taps)
    if tuple(g.shape) != (base.shape[0], taps):
        raise ValueError(f"expected cotangent {(base.shape[0], taps)}, got {tuple(g.shape)}")
    _check_pair(base, g, "window starts and cotangent")
    if not _kernel_device(base):
        return gather_window_linear_bwd_ref(base, g, length, taps)
    _contiguous(base, g, "window starts and cotangent")
    dvol = torch.empty((base.shape[0], length), dtype=torch.float32, device=base.device)
    return _launch(gather_window_linear_bwd, "anystereo_gather_window_linear_bwd", base, g, dvol,
                   base.shape[0], length, taps)


class _WindowLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vol, base, taps):
        ctx.save_for_backward(base)
        ctx.geometry = (vol.shape[1], taps)
        return _window_forward(vol, base, taps)

    @staticmethod
    def backward(ctx, g):
        (base,) = ctx.saved_tensors
        return gather_window_linear_bwd(base, g.contiguous(), *ctx.geometry), None, None


def gather_window_linear(vol: torch.Tensor, base: torch.Tensor, taps: int) -> torch.Tensor:
    """out[r, k] = lerp(vol[r], base[r] + k) for k in [0, taps), zero outside
    [0, L-1]: vol [R, L], base [R] → [R, taps], fp32.  The weight is formed
    once a row, so against `gather_rows_linear` at `base + k` it differs by
    the rounding of that sum.  Differentiable in `vol`; `base` gets no
    gradient.  Devices and launch counts as `gather_rows_linear`
    (`gather_window_linear.launches`, `gather_window_linear_bwd.launches`)."""
    return _WindowLinear.apply(vol, base, taps)


for _fn in (gather_rows_linear, gather_rows_linear_bwd, gather_window_linear,
            gather_window_linear_bwd):
    _fn.launches = 0
