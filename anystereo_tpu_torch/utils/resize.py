"""Image resize on numpy arrays, for the evaluation protocol.

The JAX package resizes with OpenCV (`cv2.resize`, `INTER_CUBIC` and
`INTER_LINEAR`) when it downscales the inputs of the arbitrary-scale
protocol, repairs a query grid that is off by a rounding, and upscales a
baseline's disparity.  The port does not depend on OpenCV; this is its own
copy of what those two modes compute: pixel centres at half-integers
(`src = (dst + 0.5)·(n_src / n_dst) - 0.5`), no antialiasing when shrinking,
edges replicated, the bicubic kernel with a = -0.75, separable (columns of
the output first along x, then along y), products and sums in float32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_CUBIC_A = -0.75


def _axis_taps(n_src: int, n_dst: int, mode: str) -> Tuple[np.ndarray, np.ndarray]:
    """(indices [n_dst, taps] into the source axis, clamped to it; weights
    [n_dst, taps]) of one axis.  Positions and weights are formed in float64
    and the weights rounded to float32 once."""
    fx = (np.arange(n_dst, dtype=np.float64) + 0.5) * (n_src / n_dst) - 0.5
    sx = np.floor(fx).astype(np.int64)
    t = fx - sx
    if mode == "linear":
        # a centre beyond the first or last source centre takes that pixel
        t = np.where((sx < 0) | (sx >= n_src - 1), 0.0, t)
        sx = np.clip(sx, 0, n_src - 1)
        idx = np.stack([sx, sx + 1], axis=1)
        wts = np.stack([1.0 - t, t], axis=1)
    elif mode == "cubic":
        a = _CUBIC_A
        w0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
        w1 = ((a + 2) * t - (a + 3)) * t * t + 1
        w2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
        idx = sx[:, None] + np.arange(-1, 3)
        wts = np.stack([w0, w1, w2, 1.0 - w0 - w1 - w2], axis=1)
    else:
        raise ValueError(f"resize mode {mode!r}: expected 'cubic' or 'linear'")
    return np.clip(idx, 0, n_src - 1), wts.astype(np.float32)


def _resize_axis(img: np.ndarray, axis: int, n_dst: int, mode: str) -> np.ndarray:
    idx, wts = _axis_taps(img.shape[axis], n_dst, mode)
    shape = [1] * img.ndim
    shape[axis] = n_dst
    out = None
    for k in range(idx.shape[1]):  # the taps in ascending order
        term = np.take(img, idx[:, k], axis=axis) * wts[:, k].reshape(shape)
        out = term if out is None else out + term
    return out


def resize(img: np.ndarray, size: Tuple[int, int], mode: str = "cubic") -> np.ndarray:
    """Resize `img` [H, W] or [H, W, C] (any channel count) to `size` =
    (width, height), the order OpenCV takes it in.  mode: "cubic" or
    "linear".  Returns float32 of the same rank."""
    w, h = int(size[0]), int(size[1])
    if img.ndim not in (2, 3) or w < 1 or h < 1:
        raise ValueError(f"expected [H, W] or [H, W, C] and a positive size, got "
                         f"{img.shape}, {size}")
    img = np.asarray(img, np.float32)
    if (img.shape[0], img.shape[1]) == (h, w):
        return img.copy()
    return _resize_axis(_resize_axis(img, 1, w, mode), 0, h, mode)
