"""The gradient of the port's pyramid lookup vs the JAX package.

`gather_pyramid_aligned` is a `torch.autograd.Function`; on the CPU its
backward is `gather_pyramid_aligned_bwd_ref`, the plain version that the
CUDA backward kernel is held to on the card (`chip_smoke.py`,
`tests/test_torch_cuda.py`).  Here that backward is held to `jax.vjp` of
the TPU kernel `gather_pyramid_aligned_pm` in Pallas interpret mode (its
own hand-written backward kernel) and of the jnp oracle, on the same
seeded inputs.

Tolerance: fp32, atol 1e-5 + rtol 1e-4.  Each gradient entry is a sum of at
most `2 * levels` products of a cotangent of order 1 and a weight in [0, 1];
the sides differ only in fp32 rounding of the weights (one per level in the
TPU kernel, one per tap here and in the oracle), ~1e-5 at positions in the
hundreds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anystereo_tpu.ops.pallas.lookup_kernel import _clamp_bounds, gather_pyramid_aligned_pm
from anystereo_tpu.ops.sampling import gather_1d_linear, pool_half_last
from anystereo_tpu_torch.ops.kernels.lookup import (
    gather_pyramid_aligned,
    gather_pyramid_aligned_bwd,
    gather_pyramid_aligned_bwd_ref,
    gather_pyramid_aligned_ref,
)

RTOL, ATOL = 1e-4, 1e-5
TAPS = 9


def _inputs(rng, r, length, levels, taps=TAPS):
    vol = rng.randn(r, length).astype(np.float32)
    # in range, partially valid, and far out of range at both signs
    x = rng.rand(r).astype(np.float32) * (length + 40) - 20
    x[:4] = [-1e6, 1e6, -3e4, 2.5e3]
    g = rng.randn(r, levels * taps).astype(np.float32)
    return vol, x, g


def _jnp_oracle(vol, x, taps, levels):
    radius = (taps - 1) // 2
    lo, hi = _clamp_bounds(vol.shape[-1], taps, levels, radius)
    xc = jnp.clip(x, lo, hi)
    k = jnp.arange(taps, dtype=jnp.float32)
    lv, outs = vol, []
    for lvl in range(levels):
        outs.append(gather_1d_linear(lv, (xc * 2.0 ** -lvl - radius)[:, None] + k))
        lv = pool_half_last(lv)
    return jnp.concatenate(outs, axis=-1)


def _torch_grad(vol, x, g, taps, levels, out_dtype=torch.float32):
    v = torch.from_numpy(vol).requires_grad_(True)
    out = gather_pyramid_aligned(v, torch.from_numpy(x), taps, levels, out_dtype)
    out.backward(torch.from_numpy(g).to(out_dtype))
    return v.grad


# L 48 / 80: the training shapes; 45 / 13: odd tails at levels 1-2; 5: a row
# shorter than the 10-cell window
@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("length", [48, 80, 45, 13, 5])
def test_grad_matches_tpu_kernel_vjp(rng, levels, length):
    vol, x, g = _inputs(rng, 24, length, levels)
    _, vjp = jax.vjp(lambda v: gather_pyramid_aligned_pm(v, jnp.asarray(x), TAPS, levels, True),
                     jnp.asarray(vol.T))
    want = np.asarray(vjp(jnp.asarray(g))[0]).T
    got = _torch_grad(vol, x, g, TAPS, levels)
    assert got.shape == vol.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("length", [48, 45, 5])
def test_grad_matches_jnp_oracle_vjp(rng, levels, length):
    vol, x, g = _inputs(rng, 24, length, levels)
    _, vjp = jax.vjp(lambda v: _jnp_oracle(v, jnp.asarray(x), TAPS, levels), jnp.asarray(vol))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = _torch_grad(vol, x, g, TAPS, levels)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_odd_tail_and_dead_rows_get_zero(rng):
    """L = 45, 3 levels: entry 44 is pooled at no level above 0 and entries
    40..43 at none above 2; rows whose position is far outside the row get
    an all-zero gradient that is written, not left out."""
    vol, x, g = _inputs(rng, 16, 45, 3)
    x[4:] = 44.0  # level-0 window [40, 49]: touches the tail
    got = _torch_grad(vol, x, g, TAPS, 3).numpy()
    assert np.all(got[:4] == 0.0)  # the four far rows
    _, vjp = jax.vjp(lambda v: _jnp_oracle(v, jnp.asarray(x), TAPS, 3), jnp.asarray(vol))
    np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(g))[0]), rtol=RTOL, atol=ATOL)
    assert np.any(got[4:, 44] != 0.0)


@pytest.mark.parametrize("length", [48, 29])
def test_bf16_cotangent_is_widened_then_summed(rng, length):
    """With bf16 output the cotangent arrives in bf16; the backward widens
    it and sums in fp32, which equals the fp32 backward of the rounded
    cotangent exactly, and the TPU kernel's to the fp32 tolerance."""
    levels = 2
    vol, x, g = _inputs(rng, 32, length, levels)
    g_rounded = torch.from_numpy(g).bfloat16().float().numpy()
    got = _torch_grad(vol, x, g, TAPS, levels, torch.bfloat16)
    assert got.dtype == torch.float32
    same = _torch_grad(vol, x, g_rounded, TAPS, levels)
    assert torch.equal(got, same)
    _, vjp = jax.vjp(
        lambda v: gather_pyramid_aligned_pm(v, jnp.asarray(x), TAPS, levels, True, "bfloat16"),
        jnp.asarray(vol.T))
    want = np.asarray(vjp(jnp.asarray(g_rounded).astype(jnp.bfloat16))[0]).T
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("levels,length,taps", [(1, 48, 9), (2, 45, 9), (3, 31, 5)])
def test_plain_backward_is_autograd_of_plain_forward(rng, levels, length, taps):
    """`gather_pyramid_aligned_bwd_ref` against PyTorch's own autograd of
    `gather_pyramid_aligned_ref` (1e-6: both sum the same few products)."""
    vol, x, g = _inputs(rng, 20, length, levels, taps)
    v = torch.from_numpy(vol).requires_grad_(True)
    gather_pyramid_aligned_ref(v, torch.from_numpy(x), taps, levels).backward(torch.from_numpy(g))
    got = gather_pyramid_aligned_bwd_ref(torch.from_numpy(x), torch.from_numpy(g), length, taps,
                                         levels)
    torch.testing.assert_close(got, v.grad, rtol=1e-6, atol=1e-6)


def test_backward_wrapper_on_cpu_counts_no_launch(rng):
    vol, x, g = _inputs(rng, 10, 48, 2)
    before = (gather_pyramid_aligned.launches, gather_pyramid_aligned_bwd.launches)
    _torch_grad(vol, x, g, TAPS, 2)
    assert (gather_pyramid_aligned.launches, gather_pyramid_aligned_bwd.launches) == before


def test_positions_get_no_gradient(rng):
    vol, x, g = _inputs(rng, 10, 48, 2)
    v = torch.from_numpy(vol).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    gather_pyramid_aligned(v, xt, TAPS, 2).backward(torch.from_numpy(g))
    assert xt.grad is None and v.grad is not None


@pytest.mark.parametrize("bad", ["g_shape", "g_dtype", "x_dtype", "levels", "device"])
def test_backward_wrapper_rejects_bad_input(bad):
    x, g = torch.zeros(4), torch.zeros(4, 18)
    kw = dict(length=16, taps=9, levels=2)
    if bad == "g_shape":
        g = torch.zeros(4, 17)
    elif bad == "g_dtype":
        g = g.half()
    elif bad == "x_dtype":
        x = x.double()
    elif bad == "levels":
        kw["levels"], g = 6, torch.zeros(4, 54)
    else:
        x, g = x.to("meta"), g.to("meta")
    with pytest.raises((TypeError, ValueError, RuntimeError)):
        gather_pyramid_aligned_bwd(x, g, **kw)
