"""The query decode of the PyTorch port (scattered coordinates: the LIIF
decoder's query path and `context_upsample_queries`) vs the JAX package,
and vs the port's own dense decode at pixel centres.

Variables are seeded over the flax module's tree and carried across with
`from_flax`, as in `tests/test_torch_modules.py`.  Tolerances: fp32 1e-4
(matmul sums reordered between XLA and ATen); bf16 3e-2 relative + absolute
(the same roundings on both sides, a few stacked); gradients 1e-4 relative
to the largest entry.  The queries include the exact corners -1 and 1,
which the sample coordinate clamps and the relative coordinate does not.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anystereo_tpu.config import LiifConfig
from anystereo_tpu.nn import liif as jliif
from anystereo_tpu.ops import coords as jcoords
from anystereo_tpu.ops import upsample as jup
from anystereo_tpu_torch import config as tcfg
from anystereo_tpu_torch.nn import liif as tliif
from anystereo_tpu_torch.nn.model import dense_query_coords
from anystereo_tpu_torch.ops import coords as tcoords
from anystereo_tpu_torch.ops import sampling as tsamp
from anystereo_tpu_torch.ops import upsample as tup
from anystereo_tpu_torch.utils.weights import from_flax

from test_torch_modules import BF16, DT, FP32, _check, _pair


def _queries(rng, b, q):
    c = (rng.rand(b, q, 2) * 2 - 1).astype(np.float32)
    c[0, :4] = [[-1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [0.0, 0.0]]
    return c


def _feats(rng, b=2):
    return [rng.randn(b, 4, 6, 20).astype(np.float32), rng.randn(b, 8, 12, 6).astype(np.float32)]


@pytest.mark.parametrize("decode_cell", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_liif_query_decode(rng, decode_cell, dtype):
    jdt, tdt = DT[dtype]
    feats, coords = _feats(rng), _queries(rng, 2, 150)
    scale = np.asarray([1.5, 2.25], np.float32)
    jm = jliif.LiifDecoder(LiifConfig(decode_cell=decode_cell), dtype=jdt)
    tm = tliif.LiifDecoder(tcfg.LiifConfig(decode_cell=decode_cell), (20, 6), dtype=tdt)
    jf = [jnp.asarray(f, jdt) for f in feats]
    var = _pair(jm, tm, jf, coords=coords, scale=scale)
    want = jm.apply(var, jf, coords=coords, scale=scale)
    got = tm([torch.from_numpy(f).to(tdt) for f in feats], coords=torch.from_numpy(coords),
             scale=torch.from_numpy(scale))
    assert got.shape == (2, 150, 9) and got.dtype == tdt
    _check(got.float().detach().numpy(), want, FP32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("gather", ["default", "plain", "kernel_function"])
def test_liif_query_decode_gradients(rng, gather, monkeypatch):
    """Gradients in the latents and the MLP through the query path: under
    the default rule, with the plain version forced, and through the
    `gather_rows` autograd function the card takes (its plain forward and
    scatter-add backward on the CPU)."""
    feats, coords = _feats(rng), _queries(rng, 2, 150)
    cot = rng.randn(2, 150, 9).astype(np.float32)
    jm = jliif.LiifDecoder(LiifConfig(), dtype=jnp.float32)
    tm = tliif.LiifDecoder(tcfg.LiifConfig(), (20, 6), dtype=torch.float32)
    jf = [jnp.asarray(f) for f in feats]
    var = _pair(jm, tm, jf, coords=coords, scale=None)
    g_var, g_feats = jax.grad(
        lambda v, f: jnp.vdot(jm.apply(v, f, coords=coords, scale=None), cot), argnums=(0, 1))(var, jf)
    tf = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    if gather == "kernel_function":
        monkeypatch.setattr(tsamp, "gather_rows_ref",
                            lambda t, i: tsamp.gather_rows(t.contiguous(), i.to(torch.int32).contiguous()))
    tsamp.set_gather_plain(gather == "plain")
    try:
        (tm(tf, coords=torch.from_numpy(coords)) * torch.from_numpy(cot)).sum().backward()
    finally:
        tsamp.set_gather_plain(False)
    for got, want in zip(tf, g_feats):
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    want_sd = from_flax(g_var)
    for name, p in tm.named_parameters():
        w = want_sd[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_context_upsample_queries(rng):
    disp = (rng.rand(2, 5, 7) * 30).astype(np.float32)
    coords = _queries(rng, 2, 90)
    w = rng.rand(2, 90, 9).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    cot = rng.randn(2, 90).astype(np.float32)
    want, vjp = jax.vjp(lambda d, ww: jup.context_upsample_queries(d, ww, jnp.asarray(coords)),
                        jnp.asarray(disp), jnp.asarray(w))
    g_disp, g_w = vjp(jnp.asarray(cot))
    td = torch.from_numpy(disp).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = tup.context_upsample_queries(td, tw, torch.from_numpy(coords))
    got.backward(torch.from_numpy(cot))
    assert got.shape == (2, 90)
    _check(got.detach().numpy(), want, dict(rtol=1e-5, atol=1e-5))
    # the 9-tap table takes the hybrid gather: its backward is the scatter
    _check(td.grad.numpy(), g_disp, dict(rtol=1e-5, atol=1e-5))
    _check(tw.grad.numpy(), g_w, dict(rtol=1e-5, atol=1e-5))


def test_clamp_coords_and_coord_helpers(rng):
    c = np.asarray([[-1.0, 1.0], [0.3, -2.0], [1.0 - 1e-7, 0.0]], np.float32)
    np.testing.assert_array_equal(tup._clamp_coords(torch.from_numpy(c)).numpy(),
                                  np.asarray(jup._clamp_coords(jnp.asarray(c))))
    np.testing.assert_allclose(tcoords.make_coord_grid(5, 7).numpy(),
                               np.asarray(jcoords.make_coord_grid(5, 7)), rtol=0, atol=1e-7)
    img = rng.randn(5, 7, 3).astype(np.float32)
    (tc, tv), (jc, jv) = tcoords.to_pixel_samples(torch.from_numpy(img)), jcoords.to_pixel_samples(
        jnp.asarray(img))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    from anystereo_tpu.nn.model import dense_query_coords as jdq

    np.testing.assert_allclose(dense_query_coords(2, 5, 7).numpy(), np.asarray(jdq(2, 5, 7)),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("decode_cell", [False, True])
def test_query_decode_at_pixel_centres_is_the_dense_decode(rng, decode_cell):
    """The port against itself: queries at the pixel centres of a 16x24
    grid give the dense separable decode of that grid (fp32, 1e-5: the same
    latents, gathered per query instead of per axis)."""
    from anystereo_tpu_torch.nn.layers import init_parameters

    feats = [torch.from_numpy(f) for f in _feats(rng)]
    scale = torch.tensor([1.5, 2.25])
    tm = init_parameters(tliif.LiifDecoder(tcfg.LiifConfig(decode_cell=decode_cell), (20, 6),
                                           dtype=torch.float32), 3)
    with torch.no_grad():
        dense = tm(feats, tcoords._axis_centers(16), tcoords._axis_centers(24), scale)
        query = tm(feats, coords=dense_query_coords(2, 16, 24), scale=scale)
    torch.testing.assert_close(query.reshape(2, 16, 24, 9), dense, rtol=1e-5, atol=1e-5)


def test_model_query_decode_at_pixel_centres_is_the_dense_forward():
    """The whole eval forward, decoded at scattered `coords` that are the
    pixel centres of a 2x grid, against its own dense decode of that grid
    (fp32, 1e-4 px on disparities of tens of px)."""
    from anystereo_tpu_torch.nn.model import MODELS

    g = torch.Generator().manual_seed(0)
    model = MODELS["continuous_IGEVStereo"](device="cpu", seed=1, max_disp=32,
                                            compute_dtype="float32")
    left = torch.rand(1, 32, 64, 3, generator=g) * 255
    right = torch.roll(left, shifts=-3, dims=2)
    grid = (tcoords._axis_centers(64), tcoords._axis_centers(128))
    dense = model(left, right, iters=2, scale=2.0, dense_grid=grid)
    query = model(left, right, iters=2, scale=2.0, coords=dense_query_coords(1, 64, 128))
    assert query.disp_preds is None and query.disp_final.shape == (1, 64 * 128)
    assert not query.disp_final.requires_grad
    torch.testing.assert_close(query.disp_final.reshape(1, 64, 128), dense.disp_final,
                               rtol=0, atol=1e-4)
