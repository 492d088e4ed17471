"""The port's Lab conversions (`anystereo_tpu_torch/utils/colorspace.py`)
against the JAX package's (`anystereo_tpu/utils/colorspace.py`) and the
reference's scalar per-pixel converter, the four cases of
`tests/test_colorspace.py`.

Tolerances: against the JAX module, bit for bit (the same float64 numpy
operations in the same order); against the scalar reference, 1e-9 relative
and absolute, as the JAX package's own test; the round trip within 2 levels
and the transferred mean within 2.5 of the style's, as there.
"""

import numpy as np
import pytest

from anystereo_tpu.utils import colorspace as jcs
from anystereo_tpu_torch.utils import colorspace as tcs

M = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)


def _f_scalar(c):
    return c ** (1 / 3) if c > 0.008856 else 7.787 * c + 0.137931


def _rgb2lab_scalar(r, g, b):
    xyz = M @ np.array([r, g, b]) / 255.0
    x, y, z = xyz[0] / 0.95047, xyz[1] / 1.0, xyz[2] / 1.08883
    fx, fy, fz = _f_scalar(x), _f_scalar(y), _f_scalar(z)
    lum = 116 * fy - 16 if y > 0.008856 else 903.3 * y
    return lum, 500 * (fx - fy), 200 * (fy - fz)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_matches_reference_scalar_math():
    rgb = np.random.RandomState(0).randint(0, 256, (5, 7, 3)).astype(np.float64)
    got = tcs.rgb_to_lab(rgb)
    _same(got, jcs.rgb_to_lab(rgb))
    for i in range(5):
        for j in range(7):
            np.testing.assert_allclose(got[i, j], _rgb2lab_scalar(*rgb[i, j]), rtol=1e-9, atol=1e-9)


def test_round_trip():
    rgb = np.random.RandomState(1).randint(20, 236, (16, 16, 3)).astype(np.float64)
    back = tcs.lab_to_rgb(tcs.rgb_to_lab(rgb))
    _same(back, jcs.lab_to_rgb(jcs.rgb_to_lab(rgb)))
    assert np.abs(back.astype(np.float64) - rgb).max() <= 2.0


def test_white_and_black():
    lab = tcs.rgb_to_lab(np.array([[255.0, 255.0, 255.0], [0.0, 0.0, 0.0]]))
    _same(lab, jcs.rgb_to_lab(np.array([[255.0, 255.0, 255.0], [0.0, 0.0, 0.0]])))
    assert abs(lab[0, 0] - 100.0) < 0.01
    np.testing.assert_allclose(lab[1], [0.0, 0.0, 0.0], atol=1e-9)


@pytest.mark.parametrize("seed", [2, 3])
def test_transfer_color_moves_statistics(seed):
    img = np.random.RandomState(seed).randint(40, 200, (32, 32, 3)).astype(np.float64)
    style_mean = np.array([[[60.0, 5.0, -5.0]]])
    style_std = np.array([[[12.0, 6.0, 6.0]]])
    out = tcs.transfer_color(img, style_mean, style_std)
    _same(out, jcs.transfer_color(img, style_mean, style_std))
    assert out.shape == img.shape
    np.testing.assert_allclose(tcs.rgb_to_lab(out).mean(axis=(0, 1)), style_mean[0, 0], atol=2.5)
