"""CIE-Lab colour conversions and a Lab-domain colour transfer, on numpy
(twin of `anystereo_tpu/utils/colorspace.py`).

Host-side helpers for augmentation and visualisation, never on the card's
path: the reference's per-pixel RGB↔Lab converters (its
`metrics_utils/Rgb2Lab.py`, dead code there) and its augmentor's unused
`transfer_color`, vectorised.  As there, the D65 sRGB→XYZ matrix is applied
to raw 0-255 intensities without gamma linearisation and divided by 255
after the matrix, and the inverse scales Z by 1.0883 (the reference's
rounding of 1.08883), so the pair round-trips with its own tables.
"""

from __future__ import annotations

import numpy as np

# linear sRGB → XYZ under D65 (the standard CIE matrix)
_M = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)
_WHITE = np.array([0.95047, 1.0, 1.08883])  # D65 reference white

_EPS = 0.008856  # (6/29)^3
_KAPPA = 7.787  # (29/6)^2 / 3, the slope of the linear segment
_OFFSET = 4.0 / 29.0


def _f(t: np.ndarray) -> np.ndarray:
    """Lab's companding: the cube root above (6/29)^3, linear below."""
    return np.where(t > _EPS, np.cbrt(np.maximum(t, 0)), _KAPPA * t + _OFFSET)


def _f_inv(t: np.ndarray) -> np.ndarray:
    """Its inverse (the threshold 0.206893 is 6/29 + the offset's rounding,
    as in the reference)."""
    return np.where(t > 0.206893, t**3, (t - _OFFSET) / _KAPPA)


def rgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] RGB (0-255) → CIE L*a*b*, float64 (L in [0, 100]): no gamma
    linearisation, /255 after the matrix, D65 white."""
    rgb = np.asarray(rgb, np.float64)
    xyz = rgb @ _M.T / 255.0 / _WHITE
    fx, fy, fz = _f(xyz[..., 0]), _f(xyz[..., 1]), _f(xyz[..., 2])
    lum = np.where(xyz[..., 1] > _EPS, 116.0 * fy - 16.0, 903.3 * xyz[..., 1])
    return np.stack([lum, 500.0 * (fx - fy), 200.0 * (fy - fz)], axis=-1)


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """CIE L*a*b* → uint8 RGB (0-255), the inverse of `rgb_to_lab` (Z scaled
    by the reference's 1.0883)."""
    lab = np.asarray(lab, np.float64)
    fy = (lab[..., 0] + 16.0) / 116.0
    fx = lab[..., 1] / 500.0 + fy
    fz = fy - lab[..., 2] / 200.0
    xyz = np.stack([_f_inv(fx) * 0.95047, _f_inv(fy), _f_inv(fz) * 1.0883], axis=-1)
    rgb = xyz * 255.0 @ np.linalg.inv(_M).T
    return np.clip(rgb, 0, 255).astype(np.uint8)


def transfer_color(image: np.ndarray, style_mean: np.ndarray, style_stddev: np.ndarray) -> np.ndarray:
    """Lab-domain colour transfer: move the image's Lab mean and standard
    deviation to (style_mean, style_stddev), clip L to [0, 100] and convert
    back.  image: [H, W, 3] RGB 0-255; the style statistics broadcast to
    [1, 1, 3].  Returns float64 RGB 0-255 (uint8 levels)."""
    lab = rgb_to_lab(image)
    mean = lab.mean(axis=(0, 1), keepdims=True)
    std = lab.std(axis=(0, 1), keepdims=True)
    out = (lab - mean) * (np.asarray(style_stddev) / std) + np.asarray(style_mean)
    out[..., 0] = np.clip(out[..., 0], 0, 100)
    return lab_to_rgb(out).astype(np.float64)
