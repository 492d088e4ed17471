"""The whole IGEV eval forward of the PyTorch port vs the JAX package.

Golden shape of `tests/test_golden.py`: 1x32x64, max_disp 32, eval mode,
dense full-resolution decode, 2 GRU iterations.  The flax variables are
made from a numpy seed over the tree `init` would build (its shapes come
from `jax.eval_shape`, which skips a 30 s compile of `init`), carried over
with `from_flax` (strict), and both models run on the same seeded images.
The JAX side takes its CPU lookup path (the jnp oracle); the port's
`pyramid_lookup` takes the plain version of the lookup kernel on the CPU.

Tolerances.  fp32: 1e-3 px absolute on disparities of 3-21 px; both sides
compute the same ops in fp32 and differ only in the order of conv and
matmul sums (measured max 1e-5 px).  bf16 (the default compute dtype):
both sides round to bf16 at the same points, but each rounding keeps 8
mantissa bits (0.4% relative), the sums under them run in other orders,
and the iterative update carries the differences forward; measured max
0.11 px, mean 0.03 px.  The band is max |diff| <= 0.5 px and mean |diff|
<= 0.1 px: under 3% of the disparity range, and far below what a
wrong channel binding or a wrong tap (several px) gives.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anystereo_tpu.config import ModelConfig as JaxConfig
from anystereo_tpu.nn.model import AnyStereo as JaxAnyStereo
from anystereo_tpu_torch.config import ModelConfig, raft_config
from anystereo_tpu_torch.nn.model import MODELS, AnyStereo, build_model
from anystereo_tpu_torch.ops.kernels.lookup import gather_pyramid_aligned
from anystereo_tpu_torch.utils.weights import from_flax

B, H, W, MAX_DISP, ITERS = 1, 32, 64, 32, 2
FP32_ATOL = 1e-3
BF16_MAX, BF16_MEAN = 0.5, 0.1


def _images():
    rng = np.random.RandomState(42)
    left = (rng.rand(B, H, W, 3) * 255).astype(np.float32)
    right = (rng.rand(B, H, W, 3) * 255).astype(np.float32)
    return left, right


def _seeded_variables(shapes, seed=7):
    """Numpy values over the flax variable tree: lecun-normal kernels,
    scales near 1 and small biases, so no norm is the trivial 1/0."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def variables():
    left, right = _images()
    jm = JaxAnyStereo(JaxConfig(max_disp=MAX_DISP, compute_dtype="float32"))
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), left, right, iters=1, mode="eval"))
    return _seeded_variables(shapes)


def _run_both(variables, dtype):
    left, right = _images()
    jm = JaxAnyStereo(JaxConfig(max_disp=MAX_DISP, compute_dtype=dtype))
    want = jax.jit(lambda v, l, r: jm.apply(v, l, r, iters=ITERS, mode="eval"))(
        variables, jnp.asarray(left), jnp.asarray(right))
    tm = AnyStereo(ModelConfig(max_disp=MAX_DISP, compute_dtype=dtype))
    tm.load_state_dict(from_flax(variables), strict=True)
    before = gather_pyramid_aligned.launches
    got = tm.eval()(torch.from_numpy(left), torch.from_numpy(right), iters=ITERS)
    assert gather_pyramid_aligned.launches == before  # the CPU takes the plain version
    return got, want


@pytest.fixture(scope="module")
def fp32_run(variables):
    return _run_both(variables, "float32")


@pytest.mark.parametrize("field", ["init_disp", "disp_lowres", "disp_final"])
def test_eval_forward_fp32(fp32_run, field):
    got, want = fp32_run
    g, w = getattr(got, field), np.asarray(getattr(want, field))
    assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
    np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=FP32_ATOL)


def test_eval_forward_bf16_band(variables):
    got, want = _run_both(variables, "bfloat16")
    assert got.disp_final.shape == (B, H, W) and got.disp_final.dtype == torch.float32
    for field in ("init_disp", "disp_lowres", "disp_final"):
        diff = np.abs(getattr(got, field).numpy() - np.asarray(getattr(want, field)))
        assert diff.max() <= BF16_MAX and diff.mean() <= BF16_MEAN, (field, diff.max())


def test_dense_grid_at_other_scale(variables):
    """An explicit output grid (2x upsampling, scale 2) decodes to its size."""
    from anystereo_tpu_torch.ops.coords import _axis_centers

    left, right = _images()
    tm = AnyStereo(ModelConfig(max_disp=MAX_DISP, compute_dtype="float32"))
    tm.load_state_dict(from_flax(variables), strict=True)
    out = tm(torch.from_numpy(left), torch.from_numpy(right), iters=1, scale=2.0,
             dense_grid=(_axis_centers(2 * H), _axis_centers(2 * W)))
    assert out.disp_final.shape == (B, 2 * H, 2 * W)
    assert torch.isfinite(out.disp_final).all()


def test_registry_builds_seeded_model_on_cpu():
    a = MODELS["continuous_IGEVStereo"](device="cpu", seed=3, max_disp=MAX_DISP)
    b = MODELS["continuous_IGEVStereo"](device="cpu", seed=3, max_disp=MAX_DISP)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert next(a.parameters()).device.type == "cpu" and not a.training
    left, right = _images()
    out = a(torch.from_numpy(left), torch.from_numpy(right), iters=1)
    assert torch.isfinite(out.disp_final).all()


def test_entry_points_never_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        build_model(ModelConfig(max_disp=MAX_DISP))
    with pytest.raises(RuntimeError):
        MODELS["continuous_IGEVStereo"](max_disp=MAX_DISP)


def test_unported_paths_raise():
    """Nothing is left to raise: the RAFT core, every stem type, the
    separable GRU and every LIIF mode build, and each mode runs an eval
    forward (densely and at queries) to a finite disparity."""
    from anystereo_tpu_torch.config import AggregationType, LiifConfig

    assert hasattr(AnyStereo(raft_config()), "fnet")
    AnyStereo(ModelConfig(max_disp=MAX_DISP, gru_type="sep"))
    AnyStereo(ModelConfig(max_disp=MAX_DISP, agg_type=AggregationType.TYPE1))

    left, right = (torch.from_numpy(a) for a in _images())
    coords = torch.rand(B, 40, 2, generator=torch.Generator().manual_seed(0)) * 2 - 1
    for liif in (LiifConfig(local_ensemble=True), LiifConfig(quarter_nearest="both"),
                 LiifConfig(quarter_nearest="only_disp"), LiifConfig(pos_enc="spatial", pos_dim=8),
                 LiifConfig(pos_enc="sinusoid"), LiifConfig(pos_enc="ipe"),
                 LiifConfig(pos_enc="learn"), LiifConfig(pos_enc="dpb")):
        AnyStereo(raft_config(liif=liif))
        model = build_model(ModelConfig(max_disp=MAX_DISP, liif=liif), device="cpu", seed=1)
        dense = model(left, right, iters=1).disp_final
        at_queries = model(left, right, iters=1, coords=coords, scale=1.5).disp_final
        assert dense.shape == (B, H, W) and at_queries.shape == (B, 40)
        assert torch.isfinite(dense).all() and torch.isfinite(at_queries).all()
