"""PyTorch port vs the JAX package: config, weight bridge, coords, sampling,
upsample and cost-volume ops.  The same numpy inputs (seeded) go through
both; tolerances are stated per test."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anystereo_tpu import config as jcfg
from anystereo_tpu.ops import coords as jcoords
from anystereo_tpu.ops import cost_volume as jcv
from anystereo_tpu.ops import sampling as jsamp
from anystereo_tpu.ops import upsample as jup
from anystereo_tpu_torch import config as tcfg
from anystereo_tpu_torch.ops import coords as tcoords
from anystereo_tpu_torch.ops import cost_volume as tcv
from anystereo_tpu_torch.ops import sampling as tsamp
from anystereo_tpu_torch.ops import upsample as tup
from anystereo_tpu_torch.utils.device import resolve_device
from anystereo_tpu_torch.utils.weights import from_flax

# fp32 tolerance for ops that reorder fp32 sums relative to XLA's
RTOL, ATOL = 1e-5, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.float() if torch.is_tensor(got) else got),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


# ----------------------------------------------------------------- config


def _plain(v):
    """Config value with enums as their strings, recursively."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v.value if hasattr(v, "value") else v


@pytest.mark.parametrize("factory", ["ModelConfig", "LiifConfig", "raft_config"])
def test_config_defaults_match(factory):
    want = _plain(dataclasses.asdict(getattr(jcfg, factory)()))
    assert _plain(dataclasses.asdict(getattr(tcfg, factory)())) == want


@pytest.mark.parametrize("kw", [dict(max_disp=50), dict(n_gru_layers=4),
                                dict(agg_type="none"), dict(n_downsample=3)])
def test_config_validation_matches(kw):
    if "agg_type" in kw:
        kw = dict(agg_type=tcfg.AggregationType.NONE)
        jkw = dict(agg_type=jcfg.AggregationType.NONE)
    else:
        jkw = kw
    with pytest.raises(ValueError):
        jcfg.ModelConfig(**jkw)
    with pytest.raises(ValueError):
        tcfg.ModelConfig(**kw)


# ----------------------------------------------------------------- device


def test_resolve_device_cpu_on_request():
    assert resolve_device("cpu").type == "cpu"


def test_resolve_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


# ----------------------------------------------------------------- weights


def test_from_flax_layouts(rng):
    conv = rng.randn(3, 5, 4, 6).astype(np.float32)
    conv3 = rng.randn(3, 3, 3, 4, 2).astype(np.float32)
    dense = rng.randn(7, 9).astype(np.float32)
    deconv = rng.randn(4, 4, 4, 8, 3).astype(np.float32)
    variables = {
        "params": {
            "a": {"Conv_0": {"kernel": conv, "bias": np.ones(6, np.float32)}},
            "b": {"kernel": conv3},
            "Dense_0": {"kernel": dense},
            "c": {"TorchConvTranspose_0": {"kernel": deconv}},
            "GroupNorm_0": {"scale": np.arange(4, dtype=np.float32)},
        },
        "batch_stats": {"FrozenBatchNorm_0": {"mean": np.zeros(2, np.float32),
                                              "var": np.ones(2, np.float32)}},
    }
    sd = from_flax(variables)
    np.testing.assert_array_equal(sd["a.Conv_0.weight"].numpy(), conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["a.Conv_0.bias"].numpy(), np.ones(6))
    np.testing.assert_array_equal(sd["b.weight"].numpy(), conv3.transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(sd["Dense_0.weight"].numpy(), dense.T)
    np.testing.assert_array_equal(sd["c.TorchConvTranspose_0.weight"].numpy(),
                                  deconv.transpose(3, 4, 0, 1, 2))
    np.testing.assert_array_equal(sd["GroupNorm_0.weight"].numpy(), np.arange(4))
    assert set(sd) >= {"FrozenBatchNorm_0.running_mean", "FrozenBatchNorm_0.running_var"}


# ----------------------------------------------------------------- coords


@pytest.mark.parametrize("shape", [(7,), (5, 9), (3, 4, 2)])
def test_make_coord(shape):
    _close(tcoords.make_coord(shape), jcoords.make_coord(shape), 0, 0)
    _close(tcoords.make_coord(shape, flatten=False), jcoords.make_coord(shape, flatten=False), 0, 0)


@pytest.mark.parametrize("n,lo,hi", [(1, -1.0, 1.0), (13, -1.0, 1.0), (8, 0.0, 3.0)])
def test_axis_centers(n, lo, hi):
    _close(tcoords._axis_centers(n, lo, hi), jcoords._axis_centers(n, lo, hi), 0, 0)


# ----------------------------------------------------------------- sampling


def test_gather_1d_linear_zero_padding(rng):
    vol = rng.randn(4, 6, 17).astype(np.float32)
    pos = (rng.rand(4, 6, 9) * 30 - 7).astype(np.float32)  # in and out of range
    _close(tsamp.gather_1d_linear(_t(vol), _t(pos)), jsamp.gather_1d_linear(vol, pos), 0, 1e-6)


def test_nearest_indices_round_half_even():
    n = 8
    # exact half-way points of the unnormalization ((c+1)*n - 1)/2 = k + 0.5
    c = np.array([(2 * k + 2) / n - 1 for k in range(-1, n)] + [-3.0, 3.0, 0.01], np.float32)
    got = tsamp._nearest_indices(_t(c), n).numpy()
    want = np.asarray(jsamp._nearest_indices(jnp.asarray(c), n))
    np.testing.assert_array_equal(got, want)


def test_nearest_dense_gather(rng):
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    ys = (rng.rand(11) * 2.2 - 1.1).astype(np.float32)
    xs = np.asarray(jcoords._axis_centers(13))
    got, iy, ix = tsamp.nearest_dense_gather(_t(x), _t(ys), _t(xs))
    want, jy, jx = jsamp.nearest_dense_gather(x, ys, xs)
    _close(got, want, 0, 0)
    np.testing.assert_array_equal(iy.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(ix.numpy(), np.asarray(jx))


@pytest.mark.parametrize("out_hw", [(12, 20), (6, 10), (1, 3)])
def test_interp_bilinear_align_corners(rng, out_hw):
    x = rng.randn(2, 6, 10, 4).astype(np.float32)
    _close(tsamp.interp_bilinear(_t(x), out_hw), jsamp.interp_bilinear(x, out_hw))


@pytest.mark.parametrize("window,stride,pad", [(3, 2, 1), (5, 4, 1), (2, 2, 0)])
def test_avg_pool2d_count_include_pad(rng, window, stride, pad):
    x = rng.randn(2, 9, 13, 3).astype(np.float32)
    _close(tsamp.avg_pool2d(_t(x), window, stride, pad), jsamp.avg_pool2d(x, window, stride, pad))


@pytest.mark.parametrize("length", [48, 45, 1])
def test_pool_half_last_floor(rng, length):
    x = rng.randn(3, 4, length).astype(np.float32)
    _close(tsamp.pool_half_last(_t(x)), jsamp.pool_half_last(x), 0, 0)


def test_nearest_resize_and_global_pool(rng):
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    _close(tsamp.nearest_resize(_t(x), (10, 13)), jsamp.nearest_resize(x, (10, 13)), 0, 0)
    _close(tsamp.global_avg_pool(_t(x)), jsamp.global_avg_pool(x))


# ----------------------------------------------------------------- upsample


@pytest.mark.parametrize("shape", [(2, 5, 7), (1, 4, 6, 3)])
def test_unfold3x3(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    _close(tup.unfold3x3(_t(x)), jup.unfold3x3(x), 0, 0)


# ----------------------------------------------------------------- cost volume


@pytest.mark.parametrize("w,max_disp", [(24, 8), (16, 16), (6, 8)])  # last: scan fallback
def test_build_gwc_and_corr(rng, w, max_disp):
    fl = rng.randn(1, 3, w, 16).astype(np.float32)
    fr = rng.randn(1, 3, w, 16).astype(np.float32)
    gwc_t, corr_t = tcv.build_gwc_and_corr(_t(fl), _t(fr), max_disp, 4)
    gwc_j, corr_j = jcv.build_gwc_and_corr(fl, fr, max_disp, 4)
    _close(gwc_t, gwc_j, 1e-5, 1e-5)
    _close(corr_t, corr_j, 1e-5, 1e-4)


def test_build_gwc_and_corr_bf16_inputs(rng):
    """bf16 features: products are exact in the fp32 accumulator."""
    fl = rng.randn(1, 2, 20, 16).astype(np.float32)
    fr = rng.randn(1, 2, 20, 16).astype(np.float32)
    gwc_t, corr_t = tcv.build_gwc_and_corr(_t(fl).bfloat16(), _t(fr).bfloat16(), 8, 4)
    gwc_j, corr_j = jcv.build_gwc_and_corr(jnp.asarray(fl, jnp.bfloat16),
                                           jnp.asarray(fr, jnp.bfloat16), 8, 4)
    assert gwc_t.dtype == torch.float32 and corr_t.dtype == torch.float32
    _close(gwc_t, gwc_j, 1e-5, 1e-5)
    _close(corr_t, corr_j, 1e-5, 1e-4)


def test_band_from_all_pairs(rng):
    ap = rng.randn(2, 9, 9).astype(np.float32)
    _close(tcv._band_from_all_pairs(_t(ap), 5), jcv._band_from_all_pairs(ap, 5), 0, 0)


def test_disparity_regression(rng):
    p = rng.rand(2, 3, 4, 12).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    _close(tcv.disparity_regression(_t(p), 12), jcv.disparity_regression(p, 12))
