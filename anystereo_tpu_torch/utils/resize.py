"""Image resize on numpy arrays, for augmentation and the evaluation protocol.

The JAX package resizes with OpenCV (`cv2.resize`, `INTER_CUBIC` and
`INTER_LINEAR`): the augmentor's scaling, crops and downscales, the 1/4-size
ground truth, the arbitrary-scale evaluation's input downscale, a query grid
that is off by a rounding, a baseline's upscaled disparity.  The port does
not depend on OpenCV; this is its own copy of what those two modes compute:
pixel centres at half-integers (`src = (dst + 0.5) * step - 0.5`, `step`
= n_src / n_dst, or 1 / fx where a scale factor is given as OpenCV's `fx`,
`fy`), no antialiasing when shrinking, edges replicated, the bicubic kernel
with a = -0.75, separable (columns of the output first along x, then along
y).  Positions are formed in float64 and rounded to float32, and the
weights computed in float32, as OpenCV does.

Float input: products and sums in float32, float32 out.  uint8 input gives
uint8, as OpenCV does: bilinear in OpenCV's fixed point (11-bit
coefficients, the row pass exact in integers, the column pass as its vector
code rounds it), bit for bit; bicubic in float32, rounded to the nearest
level and saturated (OpenCV 5 sums in another order with fused
multiply-adds: 1 level off on about 0.05% of pixels).  A bilinear resize
at a step of exactly 2 on both axes is OpenCV's 2 x 2 block mean, as there.

The per-pixel passes run in the port's C, `csrc/resize.c` (`impl="c"`, the
default; built at first use by the host C compiler, `utils/host_c.py`); the
numpy helpers below form the tap tables for it, and their numpy passes are
the plain version (`impl="numpy"`), which the C equals bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from anystereo_tpu_torch.utils import host_c

_CUBIC_A = -0.75
_COEF_SCALE = 2048  # OpenCV's INTER_RESIZE_COEF_SCALE


def _positions(n_dst: int, step: float):
    """Each output centre's source position as OpenCV forms it: in float64,
    rounded to float32; (its floor, the float32 fraction)."""
    f = ((np.arange(n_dst, dtype=np.float64) + 0.5) * step - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, f - s.astype(np.float32)


def _axis_taps(n_src: int, n_dst: int, mode: str,
               step: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(indices [n_dst, taps] into the source axis, clamped to it; weights
    [n_dst, taps], float32 arithmetic as OpenCV's)."""
    sx, t = _positions(n_dst, n_src / n_dst if step is None else step)
    one = np.float32(1)
    if mode == "linear":
        # a centre beyond the first or last source centre takes that pixel
        t = np.where((sx < 0) | (sx >= n_src - 1), np.float32(0), t)
        sx = np.clip(sx, 0, n_src - 1)
        idx = np.stack([sx, sx + 1], axis=1)
        wts = np.stack([one - t, t], axis=1)
    elif mode == "cubic":
        a = np.float32(_CUBIC_A)
        w0 = ((a * (t + one) - 5 * a) * (t + one) + 8 * a) * (t + one) - 4 * a
        w1 = ((a + 2) * t - (a + 3)) * t * t + one
        w2 = ((a + 2) * (one - t) - (a + 3)) * (one - t) * (one - t) + one
        idx = sx[:, None] + np.arange(-1, 3)
        wts = np.stack([w0, w1, w2, one - w0 - w1 - w2], axis=1)
    else:
        raise ValueError(f"resize mode {mode!r}: expected 'cubic' or 'linear'")
    return np.clip(idx, 0, n_src - 1), wts.astype(np.float32)


def _resize_axis(img: np.ndarray, axis: int, n_dst: int, mode: str,
                 step: Optional[float]) -> np.ndarray:
    idx, wts = _axis_taps(img.shape[axis], n_dst, mode, step)
    shape = [1] * img.ndim
    shape[axis] = n_dst
    out = None
    for k in range(idx.shape[1]):  # the taps in ascending order
        term = np.take(img, idx[:, k], axis=axis) * wts[:, k].reshape(shape)
        out = term if out is None else out + term
    return out


def _fixed_linear_taps(n_src: int, n_dst: int, step: float, clamp_weights: bool):
    """OpenCV's bilinear coefficients of one axis, the weights (1 - t, t)
    rounded to 11 bits.  Along x a position beyond the edge takes the edge
    pixel with weights (1, 0); along y only the rows are clamped and the
    weights stay."""
    s, t = _positions(n_dst, step)
    if clamp_weights:
        t = np.where((s < 0) | (s >= n_src - 1), np.float32(0), t)
        s = np.clip(s, 0, n_src - 1)
    wts = np.rint(np.stack([np.float32(1) - t, t], axis=1) * np.float32(_COEF_SCALE))
    return np.clip(np.stack([s, s + 1], axis=1), 0, n_src - 1), wts.astype(np.int64)


def _linear_u8(img: np.ndarray, w: int, h: int, step_x: float, step_y: float) -> np.ndarray:
    xi, xw = _fixed_linear_taps(img.shape[1], w, step_x, clamp_weights=True)
    yi, yw = _fixed_linear_taps(img.shape[0], h, step_y, clamp_weights=False)
    src = img.astype(np.int64)
    tail = (1,) * (img.ndim - 2)
    rows = src[:, xi[:, 0]] * xw[:, 0].reshape(1, w, *tail) + \
        src[:, xi[:, 1]] * xw[:, 1].reshape(1, w, *tail)
    # the column pass as OpenCV's vector code computes it: each row sum
    # shifted right by 4, multiplied by its 11-bit weight, the high 16 bits
    # kept, the two added and rounded off the last 2 bits
    out = ((rows[yi[:, 0]] >> 4) * yw[:, 0].reshape(h, 1, *tail) >> 16) + \
        ((rows[yi[:, 1]] >> 4) * yw[:, 1].reshape(h, 1, *tail) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def _halve(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """OpenCV's bilinear resize at a step of exactly 2 on both axes: the mean
    of each 2 x 2 block (its area resize), the blocks past an odd edge
    holding the pixels that exist.  uint8 with 1, 3 or 4 channels: interior
    blocks rounded half up in integers, edge blocks to the nearest even
    level; with other channel counts every block to the nearest even."""
    ys = np.minimum(np.arange(2 * h), img.shape[0] - 1)
    xs = np.minimum(np.arange(2 * w), img.shape[1] - 1)
    b = img[ys][:, xs].astype(np.int64 if img.dtype == np.uint8 else np.float32)
    total = b[0::2, 0::2] + b[0::2, 1::2] + b[1::2, 0::2] + b[1::2, 1::2]
    if img.dtype != np.uint8:
        return total * np.float32(0.25)
    edge = np.zeros(total.shape[:2], bool)
    edge[:, -1] |= 2 * w > img.shape[1]
    edge[-1] |= 2 * h > img.shape[0]
    edge |= img.ndim == 3 and img.shape[2] not in (1, 3, 4)
    out = np.where(edge.reshape(edge.shape + (1,) * (img.ndim - 2)), np.rint(total / 4.0), (total + 2) >> 2)
    return out.astype(np.uint8)


def _lib(name: str):
    P, I64 = host_c.P, host_c.I64
    argtypes = {
        "resize_axis": [P, I64, P, I64, I64, I64, I64, I64, I64, P, P],
        "resize_linear_u8": [P, I64, I64, P, I64, I64, P, P, P, P, P, P],
        "resize_halve": [P, I64, I64, I64, I64, P, I64, I64, I64],
    }[name]
    return host_c.function("resize", name, argtypes, I64 if name == "resize_axis" else None)


def _resize_c(img: np.ndarray, w: int, h: int, mode: str, step_x: float, step_y: float) -> np.ndarray:
    """The C version of what `resize` does past its checks, on a
    C-contiguous copy of `img` (uint8, or float32 as the plain one casts)."""
    u8 = img.dtype == np.uint8
    src = np.ascontiguousarray(img if u8 else np.asarray(img, np.float32))
    rows, cols = src.shape[:2]
    c = 1 if src.ndim == 2 else src.shape[2]
    out = np.empty((h, w) + src.shape[2:], src.dtype)
    ptr = lambda a: a.ctypes.data  # noqa: E731
    if mode == "linear" and step_x == step_y == 2.0:
        all_even = src.ndim == 3 and c not in (1, 3, 4)
        _lib("resize_halve")(ptr(src), u8, rows, cols, c, ptr(out), h, w, all_even)
        return out
    if u8 and mode == "linear":
        xi, xw = _fixed_linear_taps(cols, w, step_x, clamp_weights=True)
        yi, yw = _fixed_linear_taps(rows, h, step_y, clamp_weights=False)
        xi, xw, yi, yw = (np.ascontiguousarray(a, np.int64) for a in (xi, xw, yi, yw))
        scratch = np.empty((2, w * c), np.int64)
        _lib("resize_linear_u8")(ptr(src), cols, c, ptr(out), h, w, ptr(xi), ptr(xw), ptr(yi), ptr(yw),
                                 ptr(scratch[0]), ptr(scratch[1]))
        return out
    axis = _lib("resize_axis")
    xi, xw = (np.ascontiguousarray(a) for a in _axis_taps(cols, w, mode, step_x))
    yi, yw = (np.ascontiguousarray(a) for a in _axis_taps(rows, h, mode, step_y))
    mid = np.empty((rows, w) + src.shape[2:], np.float32)
    if axis(ptr(src), u8, ptr(mid), False, rows, cols, c, w, xi.shape[1], ptr(xi), ptr(xw)) or \
            axis(ptr(mid), False, ptr(out), u8, 1, rows, w * c, h, yi.shape[1], ptr(yi), ptr(yw)):
        raise ValueError(f"resize_axis takes 2 or 4 taps, not {xi.shape[1]}")
    return out


def resize(img: np.ndarray, size: Optional[Tuple[int, int]], mode: str = "cubic",
           scale: Optional[Tuple[float, float]] = None, impl: Optional[str] = None) -> np.ndarray:
    """Resize `img` [H, W] or [H, W, C] (any channel count) to `size` =
    (width, height), the order OpenCV takes it in, or, with `size` None, by
    `scale` = (fx, fy) to (round(W·fx), round(H·fy)), sampling at steps of
    1/fx and 1/fy as `cv2.resize(img, None, fx=fx, fy=fy)` does.  mode:
    "cubic" or "linear".  uint8 in gives uint8 out; anything else float32
    (module docstring).  impl: "c" (the default) or "numpy", the plain
    version (`utils/host_c.py`)."""
    impl = host_c.resolve(impl, "resize")
    if size is None:
        if scale is None:
            raise ValueError("resize needs a size or a scale")
        fx, fy = float(scale[0]), float(scale[1])
        w, h = int(round(img.shape[1] * fx)), int(round(img.shape[0] * fy))
        step_x, step_y = 1.0 / fx, 1.0 / fy
    else:
        w, h = int(size[0]), int(size[1])
        step_x = step_y = None
    if img.ndim not in (2, 3) or w < 1 or h < 1:
        raise ValueError(f"expected [H, W] or [H, W, C] and a positive size, got "
                         f"{img.shape}, {size or scale}")
    u8 = img.dtype == np.uint8
    if (img.shape[0], img.shape[1]) == (h, w):
        return img.copy() if u8 else np.asarray(img, np.float32).copy()
    step_x, step_y = step_x or img.shape[1] / w, step_y or img.shape[0] / h
    if impl == "c":
        return _resize_c(img, w, h, mode, step_x, step_y)
    if mode == "linear" and step_x == step_y == 2.0:
        return _halve(img if u8 else np.asarray(img, np.float32), w, h)
    if u8 and mode == "linear":
        return _linear_u8(img, w, h, step_x, step_y)
    out = _resize_axis(_resize_axis(np.asarray(img, np.float32), 1, w, mode, step_x), 0, h, mode,
                       step_y)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8) if u8 else out
