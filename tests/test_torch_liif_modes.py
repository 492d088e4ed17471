"""Every mode of the LIIF decoder in the PyTorch port vs the JAX package: the
positional encoders, the 4-neighbor local ensemble and the 4-nearest latent
sampling, in the query form and in the dense separable form, and the whole
model with them.

Each flax module's variable tree is taken from `jax.eval_shape(init)`, filled
from a numpy seed and carried over with `from_flax` (strict load: every
parameter path must match, `emb` and the encoders' named layers included).

Tolerances: an encoder alone 1e-5; the decoder's outputs 1e-4 (a 3-layer MLP
on top, matmul sums in another order); the dense form against the query form
on the same grid 1e-5 (the same numbers through two index paths); the eval
forward at the golden shape of `tests/test_golden.py` 1e-3 px in fp32; the
train-mode loss 1e-4 relative and each gradient ||Δ|| <= 1e-3·||g|| + 1e-6,
as in `tests/test_torch_train.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anystereo_tpu.config import LiifConfig as JaxLiifConfig
from anystereo_tpu.config import ModelConfig as JaxConfig
from anystereo_tpu.nn import liif as jliif
from anystereo_tpu.nn.model import AnyStereo as JaxAnyStereo
from anystereo_tpu.ops import upsample as jup
from anystereo_tpu.ops.coords import _axis_centers as jax_axis_centers
from anystereo_tpu.train import loss as jloss
from anystereo_tpu_torch.config import LiifConfig, ModelConfig, TrainConfig
from anystereo_tpu_torch.nn import liif as tliif
from anystereo_tpu_torch.nn.model import AnyStereo
from anystereo_tpu_torch.ops import upsample as tup
from anystereo_tpu_torch.train.step import loss_and_metrics
from anystereo_tpu_torch.utils.weights import from_flax

from test_torch_model import _seeded_variables

ENC = dict(rtol=1e-5, atol=1e-5)
DEC = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(jmod, tmod, *inputs, **kw):
    shapes = jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(0), *a, **kw), *inputs)
    var = _seeded_variables(shapes, seed=1)
    tmod.load_state_dict(from_flax(var), strict=True)
    return var


# ------------------------------------------------------------------- encoders


def _rel(rng, shape=(2, 50, 2)):
    return (rng.rand(*shape) * 2 - 1).astype(np.float32)


@pytest.mark.parametrize("out_dim", [4, 8, 16])
def test_spatial_encoding(rng, out_dim):
    rel = _rel(rng)
    jm, tm = jliif.SpatialEncoding(out_dim), tliif.SpatialEncoding(out_dim)
    init = np.asarray(jm.init(jax.random.PRNGKey(0), rel)["params"]["emb"])
    np.testing.assert_array_equal(tm.emb.detach().numpy(), init)  # the log-spaced start
    var = _pair(jm, tm, rel)
    assert [n for n, _ in tm.named_parameters()] == ["emb"] and tm.emb.requires_grad
    got = tm(_t(rel))
    assert got.shape == (2, 50, out_dim + 2) == (2, 50, tm.out_features)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jm.apply(var, rel)), **ENC)
    with pytest.raises(ValueError):
        tliif.SpatialEncoding(6)


@pytest.mark.parametrize("enc_dim", [8, 16])
def test_sinusoid_encoder(rng, enc_dim):
    rel = _rel(rng)
    jm, tm = jliif.SinusoidPositionEncoder(enc_dim=enc_dim), tliif.SinusoidPositionEncoder(enc_dim=enc_dim)
    var = _pair(jm, tm, rel)
    got = tm(_t(rel))
    assert got.shape == (2, 50, 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jm.apply(var, rel)), **ENC)


@pytest.mark.parametrize("enc_dim", [8, 16])
def test_ipe_encoder(rng, enc_dim):
    """The bank's first frequency is 2^0 - 1 = 0, so the sinc guard (|x| <
    1e-8 → 1) is on the path; a zero cell puts every entry under it."""
    rel = _rel(rng)
    cell = np.broadcast_to((2.0 / np.asarray([1.0, 2.95], np.float32)).reshape(2, 1, 1), (2, 50, 2)).copy()
    cell[0, :3] = 0.0
    jm = jliif.IpePositionEncoder(enc_dim=enc_dim)
    tm = tliif.SinusoidPositionEncoder(enc_dim=enc_dim, integrated=True)
    var = _pair(jm, tm, rel, cell)
    got = tm(_t(rel), _t(cell))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jm.apply(var, rel, cell)), **ENC)


@pytest.mark.parametrize("hidden,enc", [(8, 8), (32, 24)])
def test_learned_encoder(rng, hidden, enc):
    rel = _rel(rng)
    jm = jliif.LearnedPositionEncoder(hidden_dims=hidden, enc_dims=enc)
    tm = tliif.LearnedPositionEncoder(hidden_dims=hidden, enc_dims=enc)
    var = _pair(jm, tm, rel)
    names = {n for n, _ in tm.named_parameters()}
    assert "Wr.weight" in names and "Wr.bias" not in names and "mlp_ln1.weight" in names
    np.testing.assert_allclose(tm(_t(rel)).detach().numpy(), np.asarray(jm.apply(var, rel)), **ENC)


def test_dpb_encoder(rng):
    rel = _rel(rng)
    jm = jliif.DpbPositionEncoder(hidden_dims=16, enc_dims=16)
    tm = tliif.DpbPositionEncoder(hidden_dims=16, enc_dims=16)
    var = _pair(jm, tm, rel)
    np.testing.assert_allclose(tm(_t(rel)).detach().numpy(), np.asarray(jm.apply(var, rel)), **ENC)
    with pytest.raises(ValueError):
        tliif.DpbPositionEncoder(hidden_dims=16, enc_dims=8)


# -------------------------------------------------------------------- decoder

MODES = {
    "plain": dict(),
    "local_ensemble": dict(local_ensemble=True),
    "quarter_both": dict(quarter_nearest="both"),
    "quarter_only_disp": dict(quarter_nearest="only_disp"),
    "spatial": dict(pos_enc="spatial", pos_dim=8),
    "sinusoid": dict(pos_enc="sinusoid"),
    "ipe": dict(pos_enc="ipe", pos_dim=16),
    "learn": dict(pos_enc="learn"),
    "dpb": dict(pos_enc="dpb", pos_dim=16),
    "all_together": dict(local_ensemble=True, quarter_nearest="both", pos_enc="ipe", decode_cell=True),
}
CHANNELS = (20, 6)


def _decoder_inputs(rng):
    feats = [rng.randn(2, 4, 6, 20).astype(np.float32), rng.randn(2, 8, 12, 6).astype(np.float32)]
    ys = np.array(jax_axis_centers(16))
    xs = np.array(jax_axis_centers(24)) * 1.05  # the outer columns lie beyond the edge
    scale = np.asarray([1.5, 2.0], np.float32)
    return feats, ys, xs, scale


def _decoders(mode, feats, ys, xs, scale):
    jm = jliif.LiifDecoder(JaxLiifConfig(**MODES[mode]))
    tm = tliif.LiifDecoder(LiifConfig(**MODES[mode]), CHANNELS)
    var = _pair(jm, tm, [jnp.asarray(f) for f in feats], ys=ys, xs=xs, scale=scale)
    return jm, tm, var


@pytest.mark.parametrize("mode", list(MODES))
def test_decoder_dense_matches_jax(rng, mode):
    feats, ys, xs, scale = _decoder_inputs(rng)
    jm, tm, var = _decoders(mode, feats, ys, xs, scale)
    want = jm.apply(var, [jnp.asarray(f) for f in feats], ys=ys, xs=xs, scale=scale)
    got = tm([_t(f) for f in feats], _t(ys), _t(xs), _t(scale))
    taps = 9 if "quarter" not in mode and mode != "all_together" else 4
    assert got.shape == (2, 16, 24, taps)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **DEC)


@pytest.mark.parametrize("mode", list(MODES))
def test_decoder_queries_match_jax_and_the_dense_form(rng, mode):
    feats, ys, xs, scale = _decoder_inputs(rng)
    jm, tm, var = _decoders(mode, feats, ys, xs, scale)
    coords = (rng.rand(2, 70, 2) * 2.1 - 1.05).astype(np.float32)
    want = jm.apply(var, [jnp.asarray(f) for f in feats], jnp.asarray(coords), jnp.asarray(scale))
    got = tm([_t(f) for f in feats], coords=_t(coords), scale=_t(scale))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **DEC)
    # the dense grid as queries: the same numbers through the gather path
    grid = np.stack(np.meshgrid(ys, xs, indexing="ij"), axis=-1).reshape(1, -1, 2)
    grid = np.broadcast_to(grid, (2, grid.shape[1], 2)).astype(np.float32)
    as_queries = tm([_t(f) for f in feats], coords=_t(grid), scale=_t(scale))
    dense = tm([_t(f) for f in feats], _t(ys), _t(xs), _t(scale))
    np.testing.assert_allclose(as_queries.reshape(dense.shape).detach().numpy(), dense.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("channels", [(20, 6), (136,), (48, 48, 176)])
def test_decoder_input_dim(mode, channels):
    want = jliif.decoder_input_dim(JaxLiifConfig(**MODES[mode]), channels)
    assert tliif.decoder_input_dim(LiifConfig(**MODES[mode]), channels) == want
    tm = tliif.LiifDecoder(LiifConfig(**MODES[mode]), channels)
    assert tm.imnet.parts[0].weight.shape[1] == want
    only = dict(MODES[mode], isu_mode="only_isu")
    assert tliif.decoder_input_dim(LiifConfig(**only), channels) == \
        jliif.decoder_input_dim(JaxLiifConfig(**only), channels)


# ------------------------------------------------------------------- upsample


def test_context_upsample_queries_quarter_and_fixed_grid(rng):
    disp = (rng.rand(2, 6, 9) * 30).astype(np.float32)
    coords = (rng.rand(2, 80, 2) * 2.1 - 1.05).astype(np.float32)
    w4 = rng.rand(2, 80, 4).astype(np.float32)
    np.testing.assert_allclose(
        tup.context_upsample_queries_quarter(_t(disp), _t(w4), _t(coords)).numpy(),
        np.asarray(jup.context_upsample_queries_quarter(jnp.asarray(disp), jnp.asarray(w4),
                                                         jnp.asarray(coords))), rtol=1e-6, atol=1e-6)
    # tap order (-,-), (-,+), (+,-), (+,+): a query at a cell corner picks its four cells
    corner = np.asarray([[[-1 + 2 * 2 / 6, -1 + 2 * 3 / 9]]], np.float32)
    for tap, (iy, ix) in enumerate([(1, 2), (1, 3), (2, 2), (2, 3)]):
        one = np.zeros((1, 1, 4), np.float32)
        one[..., tap] = 1.0
        assert float(tup.context_upsample_queries_quarter(_t(disp[:1]), _t(one), _t(corner))) == \
            disp[0, iy, ix]
    w9 = rng.rand(2, 15, 20, 9).astype(np.float32)
    np.testing.assert_allclose(tup.context_upsample(_t(disp), _t(w9)).numpy(),
                               np.asarray(jup.context_upsample(jnp.asarray(disp), jnp.asarray(w9))),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- whole model

B, H, W, MAX_DISP, ITERS = 1, 32, 64, 32, 2
MODEL_MODES = ["quarter_both", "quarter_only_disp", "local_ensemble", "ipe", "all_together"]


def _images():
    rng = np.random.RandomState(42)
    return ((rng.rand(B, H, W, 3) * 255).astype(np.float32),
            (rng.rand(B, H, W, 3) * 255).astype(np.float32))


def _models(mode):
    left, right = _images()
    jm = JaxAnyStereo(JaxConfig(max_disp=MAX_DISP, compute_dtype="float32",
                                liif=JaxLiifConfig(**MODES[mode])))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), left, right, iters=1, mode="eval",
                                            scale=jnp.ones((B,))))
    variables = _seeded_variables(shapes)
    tm = AnyStereo(ModelConfig(max_disp=MAX_DISP, compute_dtype="float32", liif=LiifConfig(**MODES[mode])))
    tm.load_state_dict(from_flax(variables), strict=True)
    return jm, variables, tm.eval()


@pytest.mark.parametrize("mode", MODEL_MODES)
def test_eval_forward_with_mode_fp32(mode):
    """Dense decode at 1.5 times the input grid, scale 1.5."""
    jm, variables, tm = _models(mode)
    left, right = _images()
    oh, ow = 48, 96
    ys, xs = np.asarray(jax_axis_centers(oh)), np.asarray(jax_axis_centers(ow))
    want = jax.jit(lambda v, l, r: jm.apply(v, l, r, iters=ITERS, mode="eval", scale=jnp.asarray([1.5]),
                                            dense_grid=(jnp.asarray(ys), jnp.asarray(xs))))(
        variables, jnp.asarray(left), jnp.asarray(right))
    got = tm(_t(left), _t(right), iters=ITERS, scale=1.5, dense_grid=(_t(ys), _t(xs)))
    assert got.disp_final.shape == (B, oh, ow)
    np.testing.assert_allclose(got.disp_final.numpy(), np.asarray(want.disp_final), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.disp_lowres.numpy(), np.asarray(want.disp_lowres), rtol=0, atol=1e-3)


def test_train_gradients_with_quarter_both():
    """One train-mode forward and backward with 4-nearest latents and the
    4-tap combine (1 iteration, 128 queries): loss and every gradient
    against `jax.grad`, the batch closed over."""
    jm, variables, tm = _models("quarter_both")
    left, right = _images()
    rng = np.random.RandomState(8)
    q = 128
    batch = dict(left=left, right=right, coords=(rng.rand(B, q, 2) * 2 - 1).astype(np.float32),
                 gt=(rng.rand(B, q) * 20 + 2).astype(np.float32),
                 valid=(rng.rand(B, q) > 0.1).astype(np.float32), scale=np.asarray([1.5], np.float32),
                 gt_low=(rng.rand(B, H // 4, W // 4) * 6).astype(np.float32))
    tcfg = TrainConfig(train_iters=1, supervise_init=True, max_disp_loss=float(MAX_DISP))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        out = jm.apply({"params": p}, jb["left"], jb["right"], iters=1, coords=jb["coords"],
                       scale=jb["scale"], mode="train")
        loss, _ = jloss.sequence_loss_queries(out.disp_preds, jb["gt"], jb["valid"],
                                              max_disp=tcfg.max_disp_loss, gamma=tcfg.loss_gamma)
        return loss + jloss.init_disp_loss(out.init_disp, jb["gt_low"], tcfg.max_disp_loss)

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    loss, _ = loss_and_metrics(tm, tcfg, {k: _t(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-4)
    want = from_flax({"params": jax.tree_util.tree_map(np.asarray, want)})
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    bad = [(n, float((got[n] - w).norm()), float(w.norm())) for n, w in want.items()
           if float((got[n] - w).norm()) > 1e-3 * float(w.norm()) + 1e-6]
    assert not bad, bad
    assert float(got["liif.imnet.Dense_0.weight"].norm()) > 0
