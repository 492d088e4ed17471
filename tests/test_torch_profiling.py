"""The port's measuring helpers (`anystereo_tpu_torch/utils/profiling.py`)
against the JAX package's `utils/profiling.py`, or against arithmetic.

- `count_params` equals the JAX `count_params` of the flax parameter tree,
  whose shapes come from `jax.eval_shape` of `init` (no compile), for the
  IGEV and RAFT models at their default widths and for the reference
  regime, whose BatchNorm statistics are buffers in the port and a
  collection apart from `params` in JAX: neither counts them.
- `flops_estimate` gives the analytic count of a matrix product and a
  convolution exactly.  It is not held to the JAX `flops_estimate`, which
  reads XLA's cost analysis and counts by other rules (the docstring gives
  the figures).  On the model at a test size the count depends on shapes
  only (fp32 and bf16 compute give the same) and grows by the same amount
  with each GRU iteration.
- `pipelined_per_call` against the JAX harness on `(a + c) @ a` with a
  seeded 64x64 fp32 input of positive entries (no cancellation in the
  sums): `first_out` within 1e-5 relative, the times positive, k = 1
  refused.
- `roofline` gives the JAX `roofline`'s dict for the same spec and peaks.
- `trace` writes a Chrome trace.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anystereo_tpu import config as jax_config
from anystereo_tpu.nn.model import AnyStereo as JaxAnyStereo
from anystereo_tpu.utils import profiling as jax_profiling
from anystereo_tpu_torch import config
from anystereo_tpu_torch.nn.model import AnyStereo
from anystereo_tpu_torch.utils import profiling

FIRST_OUT_RTOL = 1e-5
SMALL_H, SMALL_W, SMALL_DISP = 32, 64, 32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: a parallel test run shares the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_param_count(cfg):
    # 64x256 keeps W/4 above the cost volume's 48 disparities
    img = jax.ShapeDtypeStruct((1, 64, 256, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda l, r: JaxAnyStereo(cfg).init(jax.random.PRNGKey(0), l, r, iters=1, mode="eval"), img, img)
    return jax_profiling.count_params(shapes["params"])


@pytest.mark.parametrize("name, want", [("ModelConfig", 12_503_409), ("raft_config", 10_914_297),
                                        ("reference_regime_config", None)])
def test_count_params_matches_jax(name, want):
    got = profiling.count_params(AnyStereo(getattr(config, name)()))
    assert got == _jax_param_count(getattr(jax_config, name)())
    if want is not None:
        assert got == want


def test_count_params_of_a_nest_of_tensors():
    shapes = {"a": (3, 4), "b": {"c": (5,)}, "d": [(2, 2), (1,)]}
    tree = jax.tree_util.tree_map(np.zeros, shapes, is_leaf=lambda x: isinstance(x, tuple))
    want = jax_profiling.count_params(tree)
    assert want == 22
    assert profiling.count_params(jax.tree_util.tree_map(torch.from_numpy, tree)) == want


def test_flops_estimate_matmul_is_exact():
    x = torch.from_numpy(np.random.RandomState(0).rand(64, 64).astype(np.float32))
    assert profiling.flops_estimate(lambda a: a @ a, x) == 2 * 64**3


def test_flops_estimate_conv_is_exact():
    """2 B C_out H_out W_out C_in k_h k_w, at every output position of a
    strided, padded convolution."""
    b, c_in, c_out, h, w, k = 2, 3, 8, 16, 20, 3
    conv = torch.nn.Conv2d(c_in, c_out, k, stride=2, padding=1)
    h_out, w_out = (h + 2 - k) // 2 + 1, (w + 2 - k) // 2 + 1
    x = torch.zeros(b, c_in, h, w)
    assert profiling.flops_estimate(conv, x) == 2 * b * c_out * h_out * w_out * c_in * k * k


@pytest.fixture(scope="module")
def model_flops():
    """{(compute dtype, iterations): FLOPs of the eval forward} at 1x32x64,
    max_disp 32, the default widths."""
    rng = np.random.RandomState(0)
    left, right = (torch.from_numpy(rng.rand(1, SMALL_H, SMALL_W, 3).astype(np.float32) * 255)
                   for _ in range(2))
    counts = {}
    for dtype in ("float32", "bfloat16"):
        model = AnyStereo(config.ModelConfig(max_disp=SMALL_DISP, compute_dtype=dtype)).eval()
        for iters in (1, 2, 3):
            counts[dtype, iters] = profiling.flops_estimate(
                lambda l, r: model(l, r, iters=iters).disp_final, left, right)
    return counts


@pytest.mark.parametrize("iters", [1, 2, 3])
def test_flops_estimate_counts_shapes_not_dtypes(model_flops, iters):
    assert model_flops["float32", iters] == model_flops["bfloat16", iters] > 0


def test_flops_estimate_is_fixed_plus_iterations(model_flops):
    c1, c2, c3 = (model_flops["float32", i] for i in (1, 2, 3))
    per = c2 - c1
    assert per > 0 and c3 - c2 == per
    assert c1 - per > 0  # the stages outside the GRU loop


def _apply(c, a):
    return (a + c) @ a


def test_pipelined_per_call_matches_jax():
    x = np.random.RandomState(0).rand(64, 64).astype(np.float32)
    per, aux = profiling.pipelined_per_call(_apply, (torch.from_numpy(x),), k=3, reps=1)
    _, jaux = jax_profiling.pipelined_per_call(_apply, (jnp.asarray(x),), k=3, reps=1)
    assert aux["first_out"].dtype == torch.float32
    np.testing.assert_allclose(aux["first_out"].numpy(), np.asarray(jaux["first_out"]),
                               rtol=FIRST_OUT_RTOL, atol=0)
    assert np.isfinite(per)
    assert aux["t1"] > 0 and aux["tk"] > 0 and aux["compile_s"] > 0
    with pytest.raises(ValueError):
        profiling.pipelined_per_call(_apply, (torch.from_numpy(x),), k=1)


def test_pipelined_per_call_chains_each_application_on_the_last():
    """Each application sees the carry of the ones before it: c grows by
    sum(out) * 1e-20 an application."""
    seen = []

    def apply_fn(c, a):
        seen.append(float(c))
        return a * 1e20

    profiling.pipelined_per_call(apply_fn, (torch.ones(2),), k=2, reps=1)
    # the first pass of chain(1) and chain(2), then reps=1 of each
    assert seen == pytest.approx([0.0, 0.0, 2.0, 0.0, 0.0, 2.0], rel=1e-6)


def test_device_timer_median_of_n_after_warmup():
    calls = []

    def fn(x):
        calls.append(1)
        return {"out": x * 2}

    t = profiling.device_timer(fn, torch.ones(4), n=3, warmup=2)
    assert len(calls) == 5 and t >= 0


@pytest.mark.parametrize("unit", ["bf16_flops", "tf32_flops", "f32_flops"])
def test_roofline_matches_jax(unit):
    spec = profiling.KernelSpec("k", flops=1e9, bytes_accessed=1e8, unit=unit)
    jspec = jax_profiling.KernelSpec("k", flops=1e9, bytes_accessed=1e8, unit=unit)
    got = profiling.roofline(spec, measured_s=1e-3, peaks=profiling.H100_PEAK)
    assert got == jax_profiling.roofline(jspec, measured_s=1e-3, peaks=profiling.H100_PEAK)
    assert profiling.roofline(spec, measured_s=1e-3) == got  # the card's peaks by default
    assert abs(got["gflops"] - 1000) < 1e-6 and abs(got["gbytes_per_s"] - 100) < 1e-6


def test_h100_peaks_are_the_data_sheets():
    assert profiling.H100_PEAK == {"bf16_flops": 989e12, "tf32_flops": 495e12, "f32_flops": 67e12,
                                   "hbm_bytes_per_s": 3.35e12}
    assert profiling.KernelSpec("k", 1.0, 1.0).unit == "f32_flops"


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    with open(logdir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert os.listdir(logdir) == ["trace.json"]
