"""Module-by-module parity of the PyTorch port with the JAX package.

Each test takes the flax module's variable tree as `init` builds it (its
shapes, from `jax.eval_shape`, which skips compiling `init`), fills it from
a numpy seed (lecun-normal kernels; norm scales, biases and statistics away
from the trivial 1/0), carries it across with `from_flax` (strict load:
every parameter path must match), runs both on the same numpy inputs and
compares.  fp32 tolerance: 1e-4 (convolution sums reordered between XLA and
ATen).  bf16 cases compare at a band of 3e-2 relative + absolute: both sides
round at the same points, but bf16 keeps 8 mantissa bits (4e-3 relative
per rounding) and a few roundings stack up.  The deep cost-aggregation
stack is held to the fp32 result instead (see its test).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anystereo_tpu.config import AggregationType, IsuMode, LiifConfig, NormType
from anystereo_tpu.nn import aggregation as jagg
from anystereo_tpu.nn import extractor as jext
from anystereo_tpu.nn import layers as jlay
from anystereo_tpu.nn import liif as jliif
from anystereo_tpu.nn import stems as jstems
from anystereo_tpu.nn import update as jupd
from anystereo_tpu_torch import config as tcfg
from anystereo_tpu_torch.nn import aggregation as tagg
from anystereo_tpu_torch.nn import extractor as text
from anystereo_tpu_torch.nn import layers as tlay
from anystereo_tpu_torch.nn import liif as tliif
from anystereo_tpu_torch.nn import stems as tstems
from anystereo_tpu_torch.nn import update as tupd
from anystereo_tpu_torch.utils.weights import from_flax

FP32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _seeded(shapes, seed=0):
    rng = np.random.RandomState(seed)

    def f(path, leaf):
        name = path[-1].key
        if name == "kernel":
            a = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name in ("bias", "mean"):
            a = 0.1 * rng.randn(*leaf.shape)
        elif name == "scale":
            a = 1.0 + 0.2 * rng.randn(*leaf.shape)
        elif name == "var":
            a = 0.5 + rng.rand(*leaf.shape)
        else:
            raise KeyError(name)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, shapes)


def _cl(x):
    """channels-last numpy → channels-first torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _to_cl(t):
    return np.moveaxis(t.float().detach().numpy(), 1, -1)


def _pair(jmod, tmod, *inputs, seed=0, **kw):
    """Seeded variables over the flax module's tree for `inputs`, loaded
    into `tmod`; returns the variables."""
    shapes = jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(seed), *a, **kw), *inputs)
    var = _seeded(shapes, seed)
    tmod.load_state_dict(from_flax(var), strict=True)
    return var


def _check(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(jnp.asarray(want, jnp.float32)), **tol)


# ----------------------------------------------------------------- layers


@pytest.mark.parametrize("norm", ["instance", "group", "layer", "frozen_batch", "none"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_norm_act_2d(rng, norm, dtype):
    jdt, tdt = DT[dtype]
    x = rng.randn(2, 9, 11, 16).astype(np.float32)
    jm = jlay.ConvNormAct(24, 3, stride=2, padding=1, norm=NormType(norm), dtype=jdt)
    tm = tlay.ConvNormAct(16, 24, 3, stride=2, padding=1, norm=tcfg.NormType(norm), dtype=tdt)
    var = _pair(jm, tm, jnp.asarray(x, jdt))
    want = jm.apply(var, jnp.asarray(x, jdt))
    got = tm(_cl(x).to(tdt))
    assert got.dtype == tdt
    _check(_to_cl(got), want, FP32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("kernel,stride,transpose", [(3, 1, False), (3, 2, False),
                                                     (1, 1, False), (4, 2, True)])
def test_conv_norm_act_3d(rng, kernel, stride, transpose):
    """The JAX package computes these as folded 2-D convs / a subpixel
    deconv; the port as plain conv3d / conv_transpose3d."""
    x = rng.randn(1, 6, 8, 10, 4).astype(np.float32)
    pad = 0 if kernel == 1 else 1
    jm = jlay.ConvNormAct(8, kernel, stride=stride, padding=pad, norm=NormType.INSTANCE,
                          transpose=transpose, dims=3)
    tm = tlay.ConvNormAct(4, 8, kernel, stride=stride, padding=pad,
                          norm=tcfg.NormType.INSTANCE, transpose=transpose, dims=3)
    var = _pair(jm, tm, jnp.asarray(x))
    _check(_to_cl(tm(_cl(x))), jm.apply(var, jnp.asarray(x)), FP32)


@pytest.mark.parametrize("k,s,p", [(4, 2, 1), (3, 2, 1)])
def test_torch_conv_transpose_2d(rng, k, s, p):
    """The bridge recognises the transposed kernel by its flax name
    (`TorchConvTranspose_n`), so the layer is tested inside ConvNormAct."""
    x = rng.randn(2, 5, 7, 6).astype(np.float32)
    jm = jlay.ConvNormAct(5, k, s, p, norm=NormType.NONE, act=None, transpose=True)
    tm = tlay.ConvNormAct(6, 5, k, s, p, norm=tcfg.NormType.NONE, act=None, transpose=True)
    var = _pair(jm, tm, jnp.asarray(x))
    _check(_to_cl(tm(_cl(x))), jm.apply(var, jnp.asarray(x)), FP32)


@pytest.mark.parametrize("skip_hw", [(8, 10), (9, 11)])  # second: nearest resize
def test_conv2x(rng, skip_hw):
    x = rng.randn(1, 4, 5, 12).astype(np.float32)
    skip = rng.randn(1, *skip_hw, 6).astype(np.float32)
    jm = jlay.Conv2x(8, deconv=True)
    tm = tlay.Conv2x(12, 6, 8, deconv=True)
    var = _pair(jm, tm, jnp.asarray(x), jnp.asarray(skip))
    _check(_to_cl(tm(_cl(x), _cl(skip))), jm.apply(var, jnp.asarray(x), jnp.asarray(skip)), FP32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm(rng, dtype):
    jdt, tdt = DT[dtype]
    x = (rng.randn(2, 6, 7, 5) * 3 + 1).astype(np.float32)
    want = jlay.instance_norm(jnp.asarray(x, jdt))
    got = tlay.instance_norm(_cl(x).to(tdt))
    _check(_to_cl(got), want, FP32 if dtype == "float32" else BF16)


def test_pixel_unshuffle(rng):
    x = rng.randn(2, 6, 8, 3).astype(np.float32)
    _check(_to_cl(tlay.pixel_unshuffle(_cl(x), 2)), jlay.pixel_unshuffle(jnp.asarray(x), 2),
           dict(rtol=0, atol=0))


# ----------------------------------------------------------------- extractor


@pytest.mark.parametrize("expand,stride,cin,cout", [(1, 1, 8, 8), (6, 2, 8, 12), (6, 1, 8, 8)])
def test_inverted_residual(rng, expand, stride, cin, cout):
    x = rng.randn(1, 8, 10, cin).astype(np.float32)
    jm = jext.InvertedResidual(cout, stride=stride, expand=expand)
    tm = text.InvertedResidual(cin, cout, stride, expand)
    var = _pair(jm, tm, jnp.asarray(x))
    _check(_to_cl(tm(_cl(x))), jm.apply(var, jnp.asarray(x)), FP32)


def test_feature_pyramid(rng):
    x = rng.randn(1, 64, 96, 3).astype(np.float32)
    jm, tm = jext.FeaturePyramid(), text.FeaturePyramid()
    var = _pair(jm, tm, jnp.asarray(x))
    want = jm.apply(var, jnp.asarray(x))
    got = tm(_cl(x))
    assert [tuple(g.shape) for g in got] == [(1, w.shape[-1]) + w.shape[1:3] for w in want]
    for g, w in zip(got, want):
        _check(_to_cl(g), w, FP32)


@pytest.mark.parametrize("n_layers", [1, 3])
def test_multi_basic_encoder(rng, n_layers):
    x = rng.randn(1, 32, 48, 3).astype(np.float32)
    jm = jext.MultiBasicEncoder(hidden_dims=(32, 24, 16), context_dims=(32, 24, 16),
                                n_layers=n_layers)
    tm = text.MultiBasicEncoder((32, 24, 16), (32, 24, 16), n_layers)
    var = _pair(jm, tm, jnp.asarray(x))
    want = jm.apply(var, jnp.asarray(x))
    got = tm(_cl(x))
    assert len(got) == len(want) == n_layers
    for (gn, gi), (wn, wi) in zip(got, want):
        _check(_to_cl(gn), wn, FP32)
        _check(_to_cl(gi), wi, FP32)


# ----------------------------------------------------------------- stems


@pytest.mark.parametrize("agg", ["type3", "type4", "type5"])
def test_stem_branch(rng, agg):
    x = rng.randn(1, 16, 24, 3).astype(np.float32)
    jm = jstems.StemBranch(AggregationType(agg))
    tm = tstems.StemBranch(tcfg.AggregationType(agg))
    var = _pair(jm, tm, jnp.asarray(x))
    want = jm.apply(var, jnp.asarray(x))
    got = tm(_cl(x))
    assert got[0] is None and want[0] is None
    for g, w in zip(got[1:], want[1:]):
        _check(_to_cl(g), w, FP32)


def test_stem_branch_unported_types_raise():
    """No stem type is unported any more: every one builds.  What still
    raises is the configuration that puts a RAFT-only type on the IGEV core."""
    for agg in tcfg.AggregationType:
        tstems.StemBranch(agg)
    for agg in (tcfg.AggregationType.IGEV, tcfg.AggregationType.NONE):
        with pytest.raises(ValueError):
            tcfg.ModelConfig(agg_type=agg)


# ----------------------------------------------------------------- aggregation


def test_feature_att(rng):
    vol = rng.randn(1, 4, 6, 8, 5).astype(np.float32)
    feat = rng.randn(1, 6, 8, 16).astype(np.float32)
    jm = jagg.FeatureAtt(5)
    tm = tagg.FeatureAtt(5, 16)
    var = _pair(jm, tm, jnp.asarray(vol), jnp.asarray(feat))
    want = jm.apply(var, jnp.asarray(vol), jnp.asarray(feat))
    _check(_to_cl(tm(_cl(vol), _cl(feat))), want, FP32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cost_aggregation(rng, dtype):
    """bf16: fifteen conv + instance-norm layers deep, the JAX package's
    folded 3-D convs round three partial sums to bf16 where conv3d rounds
    one, so the two bf16 runs differ by their own rounding noise (about
    0.04 mean on outputs of 0.1 mean magnitude).  The port is held instead
    to the fp32 result: its error there may exceed the JAX bf16 run's own
    by at most 25 % in mean and 50 % in max."""
    jdt, tdt = DT[dtype]
    h, w, d = 8, 16, 8
    vol = rng.randn(1, d, h, w, 8).astype(np.float32)
    feats = [rng.randn(1, h >> i, w >> i, c).astype(np.float32)
             for i, c in enumerate((96, 64, 192, 160))]
    jm = jagg.CostAggregation(dtype=jdt)
    tm = tagg.CostAggregation(dtype=tdt)
    jin = [jnp.asarray(f, jdt) for f in feats]
    var = _pair(jm, tm, jnp.asarray(vol, jdt), jin)
    want = jm.apply(var, jnp.asarray(vol, jdt), jin)
    got = _to_cl(tm(_cl(vol).to(tdt), [_cl(f).to(tdt) for f in feats]))
    if dtype == "float32":
        _check(got, want, FP32)
        return
    ref = np.asarray(jagg.CostAggregation().apply(
        var, jnp.asarray(vol), [jnp.asarray(f) for f in feats]))
    err_port = np.abs(got - ref)
    err_jax = np.abs(np.asarray(want, np.float32) - ref)
    assert err_port.mean() <= 1.25 * err_jax.mean(), (err_port.mean(), err_jax.mean())
    assert err_port.max() <= 1.5 * err_jax.max(), (err_port.max(), err_jax.max())


# ----------------------------------------------------------------- update


def _context(rng, b, h, w, c):
    return tuple(rng.randn(b, h, w, c).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("joint_qx", [False, True])
def test_conv_gru(rng, joint_qx):
    """joint_qx is a JAX schedule rewrite; the port computes the plain cell."""
    h = np.tanh(rng.randn(1, 6, 8, 16)).astype(np.float32)
    ctx = _context(rng, 1, 6, 8, 16)
    xs = [rng.randn(1, 6, 8, c).astype(np.float32) for c in (12, 4)]
    jm = jupd.ConvGRU(16, joint_qx=joint_qx)
    tm = tupd.ConvGRU(16, 16)
    jargs = (jnp.asarray(h), tuple(map(jnp.asarray, ctx)), *map(jnp.asarray, xs))
    var = _pair(jm, tm, *jargs)
    got = tm(_cl(h), tuple(map(_cl, ctx)), *map(_cl, xs))
    _check(_to_cl(got), jm.apply(var, *jargs), FP32)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_motion_encoder(rng, split, dtype):
    jdt, tdt = DT[dtype]
    disp = (rng.rand(1, 6, 8, 1) * 10).astype(np.float32)
    geo = rng.randn(1, 6, 8, 36).astype(np.float32)
    corr = rng.randn(1, 6, 8, 9).astype(np.float32)
    jm = jupd.BasicMotionEncoder(jdt, fuse_branch_convs=True)
    tm = tupd.BasicMotionEncoder(45, tdt)
    if split:
        jc = (jnp.asarray(geo, jdt), jnp.asarray(corr, jdt))
        tc = (torch.from_numpy(geo).to(tdt), torch.from_numpy(corr).to(tdt))
    else:
        jc = jnp.asarray(np.concatenate([geo, corr], -1), jdt)
        tc = torch.from_numpy(np.concatenate([geo, corr], -1)).to(tdt)
    var = _pair(jm, tm, jnp.asarray(disp, jdt), jc)
    want = jm.apply(var, jnp.asarray(disp, jdt), jc)
    got = tm(_cl(disp).to(tdt), tc)
    assert got.dtype == tdt
    _check(_to_cl(got), want, FP32 if dtype == "float32" else BF16)


def test_disp_head(rng):
    x = rng.randn(1, 6, 8, 16).astype(np.float32)
    jm = jupd.DispHead(32, shift_matmul=True)
    tm = tupd.DispHead(16, 32)
    var = _pair(jm, tm, jnp.asarray(x))
    _check(_to_cl(tm(_cl(x))), jm.apply(var, jnp.asarray(x)), FP32)


@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_multi_update_block(rng, n_layers):
    hd, b, h, w = (16, 16, 16), 1, 8, 12
    net = [np.tanh(rng.randn(b, h >> i, w >> i, 16)).astype(np.float32) for i in range(n_layers)]
    ctx = [_context(rng, b, h >> i, w >> i, 16) for i in range(n_layers)]
    geo = rng.randn(b, h, w, 36).astype(np.float32)
    corr = rng.randn(b, h, w, 9).astype(np.float32)
    disp = (rng.rand(b, h, w, 1) * 8).astype(np.float32)
    jm = jupd.BasicMultiUpdateBlock(hd, n_layers, joint_qx=True, head_shift_matmul=True,
                                    fuse_motion_convs=True)
    tm = tupd.BasicMultiUpdateBlock(hd, n_layers, corr_channels=45)
    jargs = ([jnp.asarray(n) for n in net], [tuple(map(jnp.asarray, c)) for c in ctx])
    jkw = dict(corr=(jnp.asarray(geo), jnp.asarray(corr)), disp=jnp.asarray(disp))
    var = _pair(jm, tm, *jargs, **jkw)
    want_net, want_delta = jm.apply(var, *jargs, **jkw)
    got_net, got_delta = tm([_cl(n) for n in net], [tuple(map(_cl, c)) for c in ctx],
                            corr=(torch.from_numpy(geo), torch.from_numpy(corr)), disp=_cl(disp))
    for g, wn in zip(got_net, want_net):
        _check(_to_cl(g), wn, FP32)
    _check(_to_cl(got_delta), want_delta, FP32)


# ----------------------------------------------------------------- liif


@pytest.mark.parametrize("dilation", [1, 2])
def test_affinity_features(rng, dilation):
    f = rng.randn(2, 6, 7, 5).astype(np.float32)
    _check(tliif.affinity_features(torch.from_numpy(f), (3, 3), dilation).numpy(),
           jliif.affinity_features(jnp.asarray(f), (3, 3), dilation), dict(rtol=1e-5, atol=1e-6))


@pytest.mark.parametrize("mode", [m.value for m in IsuMode])
def test_structure_feature(rng, mode):
    f = rng.randn(1, 5, 6, 4).astype(np.float32)
    jm = jliif.StructureFeature(IsuMode(mode))
    want = jm.apply({}, jnp.asarray(f))
    got = tliif.structure_feature(torch.from_numpy(f), tcfg.LiifConfig(isu_mode=tcfg.IsuMode(mode)))
    _check(got.numpy(), want, dict(rtol=1e-5, atol=1e-6))


def test_mlp(rng):
    x = rng.randn(3, 5, 20).astype(np.float32)
    jm = jliif.Mlp((16, 8), 9)
    tm = tliif.Mlp(20, (16, 8), 9)
    var = _pair(jm, tm, jnp.asarray(x))
    _check(tm(torch.from_numpy(x)).detach().numpy(), jm.apply(var, jnp.asarray(x)), FP32)


@pytest.mark.parametrize("decode_cell", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_liif_dense_decode(rng, decode_cell, dtype):
    from anystereo_tpu.ops.coords import _axis_centers

    jdt, tdt = DT[dtype]
    feats = [rng.randn(1, 4, 6, 20).astype(np.float32), rng.randn(1, 8, 12, 6).astype(np.float32)]
    ys, xs = np.array(_axis_centers(16)), np.array(_axis_centers(24)) * 1.05
    scale = np.asarray([1.5], np.float32)
    cfg = LiifConfig(decode_cell=decode_cell)
    jm = jliif.LiifDecoder(cfg, dtype=jdt)
    tm = tliif.LiifDecoder(tcfg.LiifConfig(decode_cell=decode_cell), (20, 6), dtype=tdt)
    jf = [jnp.asarray(f, jdt) for f in feats]
    var = _pair(jm, tm, jf, ys=ys, xs=xs, scale=scale)
    want = jm.apply(var, jf, ys=ys, xs=xs, scale=scale)
    got = tm([torch.from_numpy(f).to(tdt) for f in feats], torch.from_numpy(ys),
             torch.from_numpy(xs), torch.from_numpy(scale))
    assert got.shape == (1, 16, 24, 9) and got.dtype == tdt
    _check(got.float().detach().numpy(), want, FP32 if dtype == "float32" else BF16)


def test_liif_unported_modes_raise():
    """No decoder mode raises any more: each builds with the input width the
    JAX package computes for it and decodes densely to its tap count."""
    from anystereo_tpu.ops.coords import _axis_centers

    feats = [torch.randn(1, 4, 6, 20), torch.randn(1, 8, 12, 6)]
    ys, xs = (torch.from_numpy(np.array(_axis_centers(n))) for n in (8, 12))
    for kw, taps in ((dict(local_ensemble=True), 9), (dict(quarter_nearest="only_disp"), 4),
                     (dict(quarter_nearest="both"), 4), (dict(pos_enc="sinusoid"), 9),
                     (dict(pos_enc="learn"), 9), (dict(pos_enc="dpb"), 9), (dict(pos_enc="ipe"), 9),
                     (dict(pos_enc="spatial", pos_dim=8), 9)):
        tm = tliif.LiifDecoder(tcfg.LiifConfig(**kw), (20, 6))
        assert tm.imnet.parts[0].weight.shape[1] == jliif.decoder_input_dim(LiifConfig(**kw), (20, 6))
        out = tm(feats, ys, xs, torch.tensor([1.5]))
        assert out.shape == (1, 8, 12, taps) and torch.isfinite(out).all()
