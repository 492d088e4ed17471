"""The pyramid lookup of the PyTorch port vs the JAX package.

`gather_pyramid_aligned_ref` (the plain version the CPU path runs) against
the TPU kernel `gather_pyramid_aligned_pm` in Pallas interpret mode, and
`pyramid_lookup` against the JAX jnp path.  The CUDA kernel itself runs
only on the card: its tests are in `test_torch_cuda.py`, and
`chip_smoke.py` holds it against the plain version at the main-path shapes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anystereo_tpu.ops import lookup as jlk
from anystereo_tpu.ops.pallas.lookup_kernel import gather_pyramid_aligned_pm
from anystereo_tpu_torch.ops import lookup as tlk
from anystereo_tpu_torch.ops.kernels.lookup import (
    gather_pyramid_aligned,
    gather_pyramid_aligned_ref,
)

# fp32: the TPU kernel computes one interpolation weight per level, the
# plain version one per tap (as the jnp oracle does): they differ by
# fp32 rounding of base + k, ~1e-5 at positions in the hundreds
RTOL, ATOL = 1e-4, 1e-5


def _positions(rng, r, length):
    """In range, partially valid and far out of range."""
    x = rng.rand(r).astype(np.float32) * (length + 40) - 20
    x[:4] = [-1e6, 1e6, -3e4, 2.5e3]
    return x


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("length", [48, 312, 45])
def test_ref_matches_tpu_kernel_fp32(rng, levels, length):
    r, taps = 24, 9
    vol = rng.randn(r, length).astype(np.float32)
    x = _positions(rng, r, length)
    want = np.asarray(gather_pyramid_aligned_pm(jnp.asarray(vol.T), jnp.asarray(x), taps,
                                                levels, True))
    got = gather_pyramid_aligned_ref(torch.from_numpy(vol), torch.from_numpy(x), taps, levels)
    assert got.shape == (r, levels * taps) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("length,taps", [(48, 9), (29, 5)])
def test_ref_matches_tpu_kernel_bf16_out(rng, length, taps):
    """bf16 output: both round the fp32 result once at the store, so they
    agree to one bf16 ulp."""
    r, levels = 32, 2
    vol = rng.randn(r, length).astype(np.float32)
    x = _positions(rng, r, length)
    want = np.asarray(gather_pyramid_aligned_pm(jnp.asarray(vol.T), jnp.asarray(x), taps,
                                                levels, True, "bfloat16")).astype(np.float32)
    got = gather_pyramid_aligned_ref(torch.from_numpy(vol), torch.from_numpy(x), taps, levels,
                                     torch.bfloat16)
    assert got.dtype == torch.bfloat16
    ulp = np.abs(want) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(got.float().numpy() - want) <= ulp)


def test_wrapper_takes_plain_version_on_cpu(rng):
    vol = torch.from_numpy(rng.randn(10, 48).astype(np.float32))
    x = torch.from_numpy(rng.rand(10).astype(np.float32) * 48)
    before = gather_pyramid_aligned.launches
    got = gather_pyramid_aligned(vol, x, 9, 2)
    torch.testing.assert_close(got, gather_pyramid_aligned_ref(vol, x, 9, 2), rtol=0, atol=0)
    assert gather_pyramid_aligned.launches == before  # no kernel launch on the CPU


@pytest.mark.parametrize("bad", ["dtype", "shape", "levels", "taps", "out_dtype"])
def test_wrapper_rejects_bad_input(bad):
    vol, x = torch.zeros(4, 16), torch.zeros(4)
    kw = dict(taps=9, levels=2, out_dtype=torch.float32)
    if bad == "dtype":
        vol = vol.double()
    elif bad == "shape":
        x = torch.zeros(5)
    elif bad == "levels":
        kw["levels"] = 6
    elif bad == "taps":
        kw["taps"] = 4
    else:
        kw["out_dtype"] = torch.float16
    with pytest.raises((TypeError, ValueError)):
        gather_pyramid_aligned(vol, x, **kw)


def _pyramids(rng, b=1, h=4, w=20, g=4, d=16, levels=2, radius=4):
    corr = rng.randn(b, h, w, w).astype(np.float32)
    geo = rng.randn(b, h, w, g, d).astype(np.float32)
    disp = (rng.rand(b, h, w) * (d + 8) - 4).astype(np.float32)
    return (jlk.build_pyramid(jnp.asarray(corr), jnp.asarray(geo), levels, radius),
            tlk.build_pyramid(torch.from_numpy(corr), torch.from_numpy(geo), levels, radius),
            disp)


def test_build_pyramid_levels(rng):
    """The port keeps only the level-0 rows (the lookup pools the coarser
    levels itself); they are the JAX pyramid's level 0."""
    jp, tp, _ = _pyramids(rng, levels=3)
    assert tp.num_levels == jp.num_levels == 3 and tp.out_channels == jp.out_channels
    for a, b in ((tp.corr, jp.corr_levels[0]), (tp.geo, jp.geo_levels[0])):
        assert a.dtype == torch.float32 and a.is_contiguous()
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("split", [False, True])
def test_pyramid_lookup_matches_jnp(rng, split):
    jp, tp, disp = _pyramids(rng)
    want = jlk.pyramid_lookup(jp, jnp.asarray(disp), impl="jnp", split=split)
    got = tlk.pyramid_lookup(tp, torch.from_numpy(disp), split=split)
    want, got = (want, got) if split else ((want,), (got,))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


def test_pyramid_lookup_bf16_split(rng):
    """split + bf16 out, as the model calls it: one rounding of the fp32
    result (within one bf16 ulp of the JAX jnp path cast to bf16)."""
    jp, tp, disp = _pyramids(rng)
    want = jlk.pyramid_lookup(jp, jnp.asarray(disp), impl="jnp", split=True,
                              out_dtype=jnp.bfloat16)
    got = tlk.pyramid_lookup(tp, torch.from_numpy(disp), split=True, out_dtype=torch.bfloat16)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        b = np.asarray(b).astype(np.float32)
        assert np.all(np.abs(a.float().numpy() - b) <= np.abs(b) * 2.0 ** -7 + 1e-30)


def test_pyramid_lookup_raft_mode(rng):
    corr = rng.randn(1, 3, 24, 24).astype(np.float32)
    disp = (rng.rand(1, 3, 24) * 20).astype(np.float32)
    want = jlk.pyramid_lookup(jlk.build_pyramid(jnp.asarray(corr), None, 4, 4),
                              jnp.asarray(disp), impl="jnp")
    got = tlk.pyramid_lookup(tlk.build_pyramid(torch.from_numpy(corr), None, 4, 4),
                             torch.from_numpy(disp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert tlk.lookup_channels(4, 4, None) == jlk.lookup_channels(4, 4, None) == got.shape[-1]
