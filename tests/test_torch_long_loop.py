"""The IGEV eval forward over 32 GRU iterations, port vs the JAX package.

Every other parity test runs 1-2 iterations; an error that the GRU loop
amplifies shows only over many.  Golden shape of `tests/test_golden.py`
(1x32x64, max_disp 32), fp32, eval mode, dense full-resolution decode, 32
iterations (the evaluator's `valid_iters`).  The flax variables are made
from a numpy seed over the tree `init` would build (shapes from
`jax.eval_shape`), carried over with `from_flax` (strict); both models run
on the same seeded images.  The JAX loop is an `nn.scan`, so 32 iterations
cost one compile of one iteration.  The JAX side takes its CPU lookup path
(the jnp oracle), the port the plain version of the lookup kernel.

Band: 1e-3 px absolute on every disparity field, as at 2 iterations
(`tests/test_torch_model.py`).  Measured max |diff| 2.1e-6 px on
`init_disp` (3.4-3.7 px), 4.2e-5 px on `disp_lowres` (-5.6 to 41 px after
32 updates of random weights) and 9.2e-5 px on `disp_final` (9.6-138 px):
the loop carries the fp32 differences in the order of conv sums forward
without amplifying them past 1e-6 relative.  The file takes about 20 s on
one CPU worker.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anystereo_tpu.config import ModelConfig as JaxConfig
from anystereo_tpu.nn.model import AnyStereo as JaxAnyStereo
from anystereo_tpu_torch.config import ModelConfig
from anystereo_tpu_torch.nn.model import AnyStereo
from anystereo_tpu_torch.utils.weights import from_flax

B, H, W, MAX_DISP, ITERS = 1, 32, 64, 32, 32
ATOL = 1e-3


def _images():
    rng = np.random.RandomState(42)
    left = (rng.rand(B, H, W, 3) * 255).astype(np.float32)
    right = (rng.rand(B, H, W, 3) * 255).astype(np.float32)
    return left, right


def _seeded_variables(shapes, seed=7):
    """Numpy values over the flax variable tree: lecun-normal kernels,
    scales near 1 and small biases."""
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
def run():
    left, right = _images()
    jm = JaxAnyStereo(JaxConfig(max_disp=MAX_DISP, compute_dtype="float32"))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), left, right, iters=1, mode="eval"))
    variables = _seeded_variables(shapes)
    want = jax.jit(lambda v, l, r: jm.apply(v, l, r, iters=ITERS, mode="eval"))(
        variables, jnp.asarray(left), jnp.asarray(right))
    tm = AnyStereo(ModelConfig(max_disp=MAX_DISP, compute_dtype="float32"))
    tm.load_state_dict(from_flax(variables), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(left), torch.from_numpy(right), iters=ITERS)
    return got, want


@pytest.mark.parametrize("field", ["init_disp", "disp_lowres", "disp_final"])
def test_eval_forward_32_iterations_fp32(run, field):
    got, want = run
    g, w = getattr(got, field), np.asarray(getattr(want, field))
    assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
    assert np.isfinite(w).all()
    np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)
