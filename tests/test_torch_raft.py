"""The RAFT model family of the PyTorch port vs the JAX package: the
`BasicEncoder`, the conv stems (types none, igev_stem, type1, type2), the
separable ConvGRU, and the whole eval forward of `raft_config()`
(`corr_levels` 4, zero initial disparity) under both lookup flavors.

Shapes: 1x32x64 and 1x32x72 inputs (rows of 16 and 18 at 1/4: level 3 of the
lookup has 2 cells, and 18 leaves an odd tail at levels 2 and 3), 2 GRU
iterations, dense full-resolution decode.  Variables are seeded with numpy
over `jax.eval_shape(init)` and carried over with `from_flax` (strict both
ways: `load_state_dict(strict=True)` refuses an unused flax leaf and an
unfilled parameter alike).  The JAX side takes its CPU lookup path (the jnp
oracle); the port's `pyramid_lookup` takes the plain versions of its kernels.

Tolerances, as in `tests/test_torch_model.py`.  Modules, fp32: 1e-4 (conv sums
reordered).  Whole forward, fp32: 1e-3 px.  bf16: max |diff| <= 0.5 px and
mean <= 0.1 px (both sides round at the same points; the iterations carry the
rounding noise forward).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anystereo_tpu import config as jcfg
from anystereo_tpu.nn import extractor as jext
from anystereo_tpu.nn import stems as jstems
from anystereo_tpu.nn import update as jupd
from anystereo_tpu.nn.model import AnyStereo as JaxAnyStereo
from anystereo_tpu_torch import config as tcfg
from anystereo_tpu_torch.nn import extractor as text
from anystereo_tpu_torch.nn import stems as tstems
from anystereo_tpu_torch.nn import update as tupd
from anystereo_tpu_torch.nn.model import MODELS, AnyStereo, build_model
from anystereo_tpu_torch.ops.kernels.lookup import gather_pyramid_aligned
from anystereo_tpu_torch.ops.kernels.lookup_window import gather_pyramid_window_pm
from anystereo_tpu_torch.utils.weights import from_flax

from test_torch_model import _seeded_variables
from test_torch_modules import FP32, _check, _cl, _context, _pair, _to_cl

B, H, MAX_DISP, ITERS = 1, 32, 32, 2
FP32_ATOL = 1e-3
BF16_MAX, BF16_MEAN = 0.5, 0.1


# ----------------------------------------------------------------- modules


@pytest.mark.parametrize("downsample", [2, 3])
def test_basic_encoder(rng, downsample):
    x = rng.randn(1, 32, 48, 3).astype(np.float32)
    jm = jext.BasicEncoder(output_dim=40, downsample=downsample)
    tm = text.BasicEncoder(40, downsample)
    var = _pair(jm, tm, jnp.asarray(x))
    got = tm(_cl(x))
    assert got.shape == (1, 40, 32 >> downsample, 48 >> downsample)
    _check(_to_cl(got), jm.apply(var, jnp.asarray(x)), FP32)


@pytest.mark.parametrize("agg", ["none", "igev_stem", "type1", "type2"])
def test_stem_branch_conv_types(rng, agg):
    x = rng.randn(1, 16, 24, 3).astype(np.float32)
    jm = jstems.StemBranch(jcfg.AggregationType(agg))
    tm = tstems.StemBranch(tcfg.AggregationType(agg))
    var = _pair(jm, tm, jnp.asarray(x))
    want = jm.apply(var, jnp.asarray(x))
    got = tm(_cl(x))
    assert [g is None for g in got] == [w is None for w in want]
    assert [g.shape[1] for g in got if g is not None] == list(tstems.stem_channels(
        tcfg.AggregationType(agg)))
    assert tstems.stem_channels(tcfg.AggregationType(agg)) == jstems.stem_channels(
        jcfg.AggregationType(agg))
    for g, w in zip(got, want):
        if g is not None:
            _check(_to_cl(g), w, FP32)


def test_sep_conv_gru(rng):
    h = np.tanh(rng.randn(1, 6, 8, 16)).astype(np.float32)
    xs = [rng.randn(1, 6, 8, c).astype(np.float32) for c in (12, 4)]
    jm = jupd.SepConvGRU(16)
    tm = tupd.SepConvGRU(16, 16)
    jargs = (jnp.asarray(h), *map(jnp.asarray, xs))
    var = _pair(jm, tm, *jargs)
    assert sorted(var["params"]) == ["convqh", "convqv", "convrh", "convrv", "convzh", "convzv"]
    got = tm(_cl(h), None, *map(_cl, xs))  # the context biases are dropped
    _check(_to_cl(got), jm.apply(var, *jargs), FP32)


@pytest.mark.parametrize("gru_type", ["conv", "sep"])
def test_multi_update_block_raft_input(rng, gru_type):
    """The RAFT split input: one part, (corr,), of 4 levels x 9 taps."""
    hd, b, h, w, n_layers = (16, 16, 16), 1, 8, 12, 3
    net = [np.tanh(rng.randn(b, h >> i, w >> i, 16)).astype(np.float32) for i in range(n_layers)]
    ctx = [_context(rng, b, h >> i, w >> i, 16) for i in range(n_layers)]
    corr = rng.randn(b, h, w, 36).astype(np.float32)
    disp = (rng.rand(b, h, w, 1) * 8).astype(np.float32)
    jm = jupd.BasicMultiUpdateBlock(hd, n_layers, gru_type=gru_type)
    tm = tupd.BasicMultiUpdateBlock(hd, n_layers, corr_channels=36, gru_type=gru_type)
    jargs = ([jnp.asarray(n) for n in net], [tuple(map(jnp.asarray, c)) for c in ctx])
    jkw = dict(corr=(jnp.asarray(corr),), disp=jnp.asarray(disp))
    var = _pair(jm, tm, *jargs, **jkw)
    want_net, want_delta = jm.apply(var, *jargs, **jkw)
    got_net, got_delta = tm([_cl(n) for n in net], [tuple(map(_cl, c)) for c in ctx],
                            corr=(torch.from_numpy(corr),), disp=_cl(disp))
    for g, wn in zip(got_net, want_net):
        _check(_to_cl(g), wn, FP32)
    _check(_to_cl(got_delta), want_delta, FP32)
    with pytest.raises(ValueError):
        tupd.BasicMultiUpdateBlock(hd, n_layers, gru_type="lstm")


# ------------------------------------------------------- the whole forward


def _images(w):
    rng = np.random.RandomState(42)
    left = (rng.rand(B, H, w, 3) * 255).astype(np.float32)
    right = (rng.rand(B, H, w, 3) * 255).astype(np.float32)
    return left, right


def _variables(w, **kw):
    left, right = _images(w)
    jm = JaxAnyStereo(jcfg.raft_config(max_disp=MAX_DISP, compute_dtype="float32", **kw))
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), left, right, iters=1, mode="eval"))
    return _seeded_variables(shapes)


def _kw(cfg_module, kw):
    """Config overrides with `agg_type` as that package's enum."""
    kw = dict(kw)
    if "agg_type" in kw:
        kw["agg_type"] = cfg_module.AggregationType(kw["agg_type"])
    return kw


def _run_jax(variables, w, dtype, iters=ITERS, **kw):
    left, right = _images(w)
    jm = JaxAnyStereo(jcfg.raft_config(max_disp=MAX_DISP, compute_dtype=dtype, **_kw(jcfg, kw)))
    return jax.jit(lambda v, l, r: jm.apply(v, l, r, iters=iters, mode="eval"))(
        variables, jnp.asarray(left), jnp.asarray(right))


def _run_torch(variables, w, dtype, kernel, monkeypatch, iters=ITERS, **kw):
    left, right = _images(w)
    monkeypatch.setenv("ANYSTEREO_LOOKUP_KERNEL", kernel)
    tm = AnyStereo(tcfg.raft_config(max_disp=MAX_DISP, compute_dtype=dtype, **_kw(tcfg, kw)))
    tm.load_state_dict(from_flax(variables), strict=True)
    before = (gather_pyramid_aligned.launches, gather_pyramid_window_pm.launches)
    got = tm.eval()(torch.from_numpy(left), torch.from_numpy(right), iters=iters)
    # the CPU takes the plain versions
    assert (gather_pyramid_aligned.launches, gather_pyramid_window_pm.launches) == before
    return got


_CASES = {}


def _fp32_case(w):
    """(variables, the JAX fp32 forward) at width w, computed once."""
    if w not in _CASES:
        variables = _variables(w)
        _CASES[w] = (variables, _run_jax(variables, w, "float32"))
    return _CASES[w]


@pytest.mark.parametrize("w", [64, 72])
@pytest.mark.parametrize("kernel", ["aligned", "classify"])
def test_raft_eval_forward_fp32(w, kernel, monkeypatch):
    variables, want = _fp32_case(w)
    assert want.init_disp is None
    got = _run_torch(variables, w, "float32", kernel, monkeypatch)
    assert got.init_disp is None and got.disp_preds is None
    for field in ("disp_lowres", "disp_final"):
        g, wv = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == torch.float32 and tuple(g.shape) == wv.shape
        np.testing.assert_allclose(g.numpy(), wv, rtol=0, atol=FP32_ATOL, err_msg=field)
    assert got.disp_final.shape == (B, H, w) and got.disp_lowres.shape == (B, H // 4, w // 4)


@pytest.mark.parametrize("kernel", ["aligned", "classify"])
def test_raft_eval_forward_bf16_band(kernel, monkeypatch):
    w = 64
    variables, _ = _fp32_case(w)
    if "bf16" not in _CASES:
        _CASES["bf16"] = _run_jax(variables, w, "bfloat16")
    want = _CASES["bf16"]
    got = _run_torch(variables, w, "bfloat16", kernel, monkeypatch)
    assert got.disp_final.dtype == torch.float32
    for field in ("disp_lowres", "disp_final"):
        diff = np.abs(getattr(got, field).numpy() - np.asarray(getattr(want, field)))
        assert diff.max() <= BF16_MAX and diff.mean() <= BF16_MEAN, (field, diff.max(), diff.mean())


_VARIANTS = {
    "agg_none": dict(agg_type="none"),
    "agg_none_eighth": dict(agg_type="none", n_downsample=3),
    "agg_igev_stem": dict(agg_type="igev_stem"),
    "agg_type1": dict(agg_type="type1"),
    "agg_type2": dict(agg_type="type2"),
    "gru_sep": dict(gru_type="sep"),
    "two_gru_levels_slow_fast": dict(n_gru_layers=2, slow_fast_gru=True),
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_raft_variants_one_forward(variant, monkeypatch):
    """Every stem type, the separable GRU and a second resolution of the
    RAFT core: one fp32 forward each against the JAX package (1e-3 px)."""
    kw, w = _VARIANTS[variant], 64
    variables = _variables(w, **_kw(jcfg, kw))
    want = _run_jax(variables, w, "float32", iters=1, **kw)
    got = _run_torch(variables, w, "float32", "aligned", monkeypatch, iters=1, **kw)
    down = kw.get("n_downsample", 2)
    assert got.disp_lowres.shape == (B, H >> down, w >> down)
    for field in ("disp_lowres", "disp_final"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=0, atol=FP32_ATOL, err_msg=field)


def test_registry_builds_raft_on_cpu_and_wants_the_card_otherwise(monkeypatch):
    a = MODELS["continuous_RAFTStereo"](device="cpu", seed=3, max_disp=MAX_DISP)
    b = MODELS["continuous_RAFTStereo"](device="cpu", seed=3, max_disp=MAX_DISP)
    assert a.cfg == tcfg.raft_config(max_disp=MAX_DISP) and a.cfg.corr_levels == 4
    assert a.cfg.lookup_channels == 36 and not hasattr(a, "cost_agg") and hasattr(a, "fnet")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert next(a.parameters()).device.type == "cpu" and not a.training
    left, right = _images(64)
    out = a(torch.from_numpy(left), torch.from_numpy(right), iters=1)
    assert out.init_disp is None and torch.isfinite(out.disp_final).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        MODELS["continuous_RAFTStereo"](max_disp=MAX_DISP)
    with pytest.raises(RuntimeError):
        build_model(tcfg.raft_config(max_disp=MAX_DISP))


def test_bridge_is_strict_both_ways():
    """An unused flax leaf and an unfilled parameter both refuse to load."""
    variables = _variables(64)
    tm = AnyStereo(tcfg.raft_config(max_disp=MAX_DISP))
    sd = from_flax(variables)
    assert set(sd) == set(tm.state_dict())
    extra = dict(sd, **{"fnet.Conv_9.weight": torch.zeros(1)})
    with pytest.raises(RuntimeError):
        tm.load_state_dict(extra, strict=True)
    missing = {k: v for k, v in sd.items() if not k.startswith("fnet.Conv_1.")}
    with pytest.raises(RuntimeError):
        tm.load_state_dict(missing, strict=True)
