"""The port's three plain cost-volume functions (`ops/cost_volume.py`:
`build_correlation_volume`, `build_norm_correlation_volume`,
`build_concat_volume`) and `context_upsample(scale=)` against the JAX
package's, on inputs made from a numpy seed.

Shapes: B 1-2, H 4-8, W 8-16, C 8, `max_disp` 1, 6 and W, fp32 and bf16.
Bands: the fp32 correlations within 1e-5 abs + 1e-5 rel (the same products,
summed in another order); in bf16 the dot-product volume is fp32 on both
sides (products of bf16 values are exact in fp32) and is held to the same
band, while the cosine volume, computed in bf16 on both sides as the JAX
package does, is held within one bf16 rounding of its magnitude (2^-8 rel
+ 2^-8 abs: a quotient and a mean, each rounded once); the concat volume
exactly.  The zero-disparity triangle (w < d) is exactly zero in every
volume.  The JAX side is one jit a shape and dtype at `max_disp` W, whose
prefix along D is its volume at each smaller `max_disp`.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anystereo_tpu.ops import cost_volume as _jcv
from anystereo_tpu.ops import upsample as jup
from anystereo_tpu_torch.ops import cost_volume as tcv
from anystereo_tpu_torch.ops import upsample as tup

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_NORM = dict(rtol=2.0 ** -8, atol=2.0 ** -8)
SHAPES = [(1, 4, 8), (2, 8, 16), (2, 5, 12)]  # B, H, W
C = 8
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _features(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    b, h, w = shape
    fl, fr = (rng.randn(b, h, w, C).astype(np.float32) for _ in range(2))
    tdt, jdt = DTYPES[dtype]
    # the same values on both sides: rounded to bf16 once, by torch
    tl, tr = torch.from_numpy(fl).to(tdt), torch.from_numpy(fr).to(tdt)
    jl, jr = (jnp.asarray(t.float().numpy()).astype(jdt) for t in (tl, tr))
    return tl, tr, jl, jr


@functools.lru_cache(maxsize=None)
def _jax_volume(name, shape, dtype, seed, max_disp):
    """The JAX function's volume at `max_disp`, one jit a case.  Its slice d
    depends on d alone (each is built on its own), so the volume at a smaller
    `max_disp` is a prefix of it along the last axis."""
    _, _, jl, jr = _features(shape, dtype, seed)
    return jax.jit(getattr(_jcv, name), static_argnums=2)(jl, jr, max_disp)


def _jax(name, shape, dtype, seed, max_disp):
    vol = _jax_volume(name, shape, dtype, seed, max(max_disp, shape[2]))
    return vol[..., :max_disp]


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x.astype(jnp.float32))


def _cases():
    return [(shape, d, dtype) for shape in SHAPES for d in (1, 6, shape[2]) for dtype in DTYPES]


def _triangle(vol, disp_axis, w_axis=2):
    """The entries with w < d, as a flat array."""
    w, d = vol.shape[w_axis], vol.shape[disp_axis]
    mask = np.arange(w)[:, None] < np.arange(d)[None, :]
    moved = np.moveaxis(vol, (w_axis, disp_axis), (-2, -1))
    return moved[..., mask]


@pytest.mark.parametrize("shape,max_disp,dtype", _cases())
def test_correlation_volume(shape, max_disp, dtype):
    tl, tr, _, _ = _features(shape, dtype, seed=0)
    got = tcv.build_correlation_volume(tl, tr, max_disp)
    want = _jax("build_correlation_volume", shape, dtype, 0, max_disp)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert tuple(got.shape) == want.shape == (*shape, max_disp)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert not _triangle(_np(got), -1).any()


@pytest.mark.parametrize("shape,max_disp,dtype", _cases())
def test_norm_correlation_volume(shape, max_disp, dtype):
    tl, tr, _, _ = _features(shape, dtype, seed=1)
    got = tcv.build_norm_correlation_volume(tl, tr, max_disp)
    want = _jax("build_norm_correlation_volume", shape, dtype, 1, max_disp)
    assert got.dtype == DTYPES[dtype][0] and want.dtype == DTYPES[dtype][1]
    assert tuple(got.shape) == want.shape == (*shape, max_disp)
    np.testing.assert_allclose(_np(got), _np(want), **(F32 if dtype == "float32" else BF16_NORM))
    assert not _triangle(_np(got), -1).any()
    # cosine of a feature with itself at d = 0, over C
    assert np.abs(_np(tcv.build_norm_correlation_volume(tl, tl, 1))).max() <= 1.0 / C + 1e-2


@pytest.mark.parametrize("shape,max_disp,dtype", _cases())
def test_concat_volume(shape, max_disp, dtype):
    tl, tr, _, _ = _features(shape, dtype, seed=2)
    got = tcv.build_concat_volume(tl, tr, max_disp)
    want = _jax("build_concat_volume", shape, dtype, 2, max_disp)
    assert got.dtype == DTYPES[dtype][0] and want.dtype == DTYPES[dtype][1]
    assert tuple(got.shape) == want.shape == (*shape, 2 * C, max_disp)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert not _triangle(_np(got)[..., C:, :], -1).any()
    np.testing.assert_array_equal(_np(got)[..., :C, -1], _np(tl))  # the left features at every d


def test_correlation_volumes_beyond_the_row():
    """A `max_disp` past W: the disparities with no right pixel are zero
    planes on both sides."""
    tl, tr, _, _ = _features((1, 4, 8), "float32", seed=3)
    for name in ("build_correlation_volume", "build_norm_correlation_volume", "build_concat_volume"):
        got, want = getattr(tcv, name)(tl, tr, 11), _jax(name, (1, 4, 8), "float32", 3, 11)
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        tail = _np(got)[..., 8:]
        assert not (tail[..., C:, :] if name == "build_concat_volume" else tail).any(), name


@pytest.mark.parametrize("scale", [1.0, 1.5, 0.37])
def test_context_upsample_scale(scale):
    """`scale` is taken and does not enter the result: the output grid is
    the weights' (round(4*H*scale) x round(4*W*scale)), as in the JAX body."""
    rng = np.random.RandomState(4)
    b, h, w = 2, 5, 7
    oh, ow = round(4 * h * scale), round(4 * w * scale)
    disp = (rng.rand(b, h, w) * 10).astype(np.float32)
    weights = rng.rand(b, oh, ow, 9).astype(np.float32)
    got = tup.context_upsample(torch.from_numpy(disp), torch.from_numpy(weights), scale=scale)
    want = jax.jit(jup.context_upsample, static_argnums=2)(jnp.asarray(disp), jnp.asarray(weights), scale)
    assert tuple(got.shape) == want.shape == (b, oh, ow)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    torch.testing.assert_close(got, tup.context_upsample(torch.from_numpy(disp), torch.from_numpy(weights)),
                               rtol=0, atol=0)
