"""The port's query row gather (`ops/kernels/gather.py`, `ops/sampling.py`)
vs the JAX package.

The JAX side runs as `tests/test_gather_kernel.py` runs it: the Pallas
kernels `gather_rows` / `gather_rows_hybrid` in interpret mode, and the jnp
row gather as the oracle.  On the CPU the port's wrappers take their plain
versions, through the same `torch.autograd.Function`s that launch the CUDA
kernels on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`), so the
backward formula (fp32 sum of the cotangent in its own dtype, duplicates
summed, cast to the table's dtype after the sum) is what is held here.

Tolerances.  Forward: exact (a copy of rows).  Backward, fp32: rtol 1e-5 +
atol 1e-5 (sums of up to ~16 cotangents in another order).  Backward, bf16
table: the gradient is an fp32 sum rounded once to bf16, so it sits within
one bf16 ulp (2^-7 relative) of the fp32 oracle.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anystereo_tpu.ops import sampling as jsamp
from anystereo_tpu.ops.pallas import gather_kernel as jgk
from anystereo_tpu_torch.ops import sampling as tsamp
from anystereo_tpu_torch.ops.kernels.gather import (
    gather_rows,
    gather_rows_hybrid,
    gather_rows_ref,
    scatter_rows_add,
    scatter_rows_add_ref,
)

# (B, N, C, Q): tiny; non-multiples everywhere with B > 1; the 9-tap
# disparity table's width with Q >> N (every row hit many times)
SHAPES = [(1, 64, 8, 32), (2, 513, 33, 257), (2, 40, 9, 640)]
IMPLS = {"kernel": (gather_rows, jgk.gather_rows), "hybrid": (gather_rows_hybrid, jgk.gather_rows_hybrid)}


def _rand(rng, b, n, c, q):
    table = rng.randn(b, n, c).astype(np.float32)
    idx = rng.randint(0, n, size=(b, q)).astype(np.int32)  # duplicates on purpose
    idx[:, :2] = [0, n - 1]
    cot = rng.randn(b, q, c).astype(np.float32)
    return table, idx, cot


def _oracle(table, idx):
    return jax.vmap(lambda f, i: jnp.take(f, i, axis=0))(table, idx)


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_exact_fp32(rng, impl, shape):
    table, idx, _ = _rand(rng, *shape)
    tfn, jfn = IMPLS[impl]
    got = tfn(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (shape[0], shape[3], shape[2])
    np.testing.assert_array_equal(got.numpy(), np.asarray(_oracle(jnp.asarray(table), jnp.asarray(idx))))
    # the TPU kernel reconstructs fp32 rows from a 3-term bf16 split: 1 ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(jfn(jnp.asarray(table), jnp.asarray(idx), True)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_forward_exact_bf16(rng, impl):
    table, idx, _ = _rand(rng, 2, 300, 48, 500)
    tfn, jfn = IMPLS[impl]
    got = tfn(torch.from_numpy(table).bfloat16(), torch.from_numpy(idx))
    want = jfn(jnp.asarray(table).astype(jnp.bfloat16), jnp.asarray(idx), True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_sums_duplicates_fp32(rng, impl, shape):
    table, idx, cot = _rand(rng, *shape)
    tfn, jfn = IMPLS[impl]
    t = torch.from_numpy(table).requires_grad_(True)
    tfn(t, torch.from_numpy(idx)).backward(torch.from_numpy(cot))
    j_idx, j_cot = jnp.asarray(idx), jnp.asarray(cot)
    g_kernel = jax.grad(lambda tb: jnp.vdot(jfn(tb, j_idx, True), j_cot))(jnp.asarray(table))
    g_oracle = jax.grad(lambda tb: jnp.vdot(_oracle(tb, j_idx), j_cot))(jnp.asarray(table))
    assert t.grad.dtype == torch.float32
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_oracle), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_kernel), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_backward_bf16_table_fp32_sum_then_cast(rng, impl):
    """bf16 table and bf16 cotangent, as the latents have in training."""
    table, idx, cot = _rand(rng, 2, 64, 16, 512)
    tfn, jfn = IMPLS[impl]
    cot_bf = torch.from_numpy(cot).bfloat16()
    t = torch.from_numpy(table).bfloat16().requires_grad_(True)
    tfn(t, torch.from_numpy(idx)).backward(cot_bf)
    assert t.grad.dtype == torch.bfloat16
    # the rule itself: fp32 sum of the bf16 cotangent, one rounding after
    want = scatter_rows_add_ref(torch.from_numpy(idx), cot_bf, 64).bfloat16()
    assert torch.equal(t.grad, want)
    # the JAX kernel on the same bf16 cotangent: both round an fp32 sum once
    j_cot = jnp.asarray(cot_bf.float().numpy()).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda tb: jfn(tb, jnp.asarray(idx), True),
                     jnp.asarray(table).astype(jnp.bfloat16))
    g_j = np.asarray(vjp(j_cot)[0], np.float32)
    assert np.all(np.abs(t.grad.float().numpy() - g_j) <= np.abs(g_j) * 2.0 ** -7 + 1e-6)


def test_scatter_rows_add_matches_tpu_backward_kernel(rng):
    _, idx, cot = _rand(rng, 2, 513, 33, 257)
    got = scatter_rows_add(torch.from_numpy(idx), torch.from_numpy(cot), 513)
    want = jgk._gather_rows_pallas_bwd(jnp.asarray(idx), jnp.asarray(cot), 513, True)
    assert got.dtype == torch.float32 and got.shape == (2, 513, 33)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cpu_takes_plain_versions_and_counts_no_launch(rng):
    table, idx, cot = _rand(rng, 2, 40, 9, 640)
    before = (gather_rows.launches, scatter_rows_add.launches)
    t = torch.from_numpy(table).requires_grad_(True)
    out = gather_rows(t, torch.from_numpy(idx))
    out.backward(torch.from_numpy(cot))
    assert torch.equal(out, gather_rows_ref(t, torch.from_numpy(idx)))
    assert torch.equal(t.grad, scatter_rows_add_ref(torch.from_numpy(idx), torch.from_numpy(cot), 40))
    assert (gather_rows.launches, scatter_rows_add.launches) == before


@pytest.mark.parametrize("bad", ["idx_dtype", "idx_shape", "table_dtype", "table_rank", "oob", "device"])
def test_wrappers_reject_bad_input(bad):
    table, idx = torch.zeros(2, 8, 4), torch.zeros(2, 5, dtype=torch.int32)
    if bad == "idx_dtype":
        idx = idx.long()
    elif bad == "idx_shape":
        idx = torch.zeros(3, 5, dtype=torch.int32)
    elif bad == "table_dtype":
        table = table.half()
    elif bad == "table_rank":
        table = torch.zeros(8, 4)
    elif bad == "oob":
        idx[0, 0] = 8  # a bad index raises on the CPU
    else:
        table, idx = table.to("meta"), idx.to("meta")
    with pytest.raises((TypeError, ValueError, IndexError, RuntimeError)):
        gather_rows(table, idx)
    if bad in ("idx_dtype", "idx_shape", "oob", "device"):
        with pytest.raises((TypeError, ValueError, IndexError, RuntimeError)):
            scatter_rows_add(idx, torch.zeros(2, 5, 4, device=idx.device), 8)


# ------------------------------------------------------------- the dispatch

_J_IMPLS = ("jnp", "pallas", "hybrid")


@pytest.fixture
def no_override(monkeypatch):
    monkeypatch.delenv("ANYSTEREO_GATHER_IMPL", raising=False)
    yield
    tsamp.set_gather_plain(False)
    jsamp.set_gather_override(None)


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("jimpl", _J_IMPLS)
def test_gather_rows_flat_under_each_override(rng, no_override, jimpl, plain):
    """The port's one gather path (and its forced plain version) against each
    of the JAX package's three implementations."""
    table, idx, cot = _rand(rng, 2, 120, 9, 300)
    tsamp.set_gather_plain(plain)
    jsamp.set_gather_override(jimpl, interpret=True)
    t = torch.from_numpy(table).requires_grad_(True)
    got = tsamp.gather_rows_flat(t, torch.from_numpy(idx).long())  # indices as nearest_sample makes them
    got.backward(torch.from_numpy(cot))
    j_idx, j_cot = jnp.asarray(idx), jnp.asarray(cot)
    want, vjp = jax.vjp(lambda tb: jsamp.gather_rows_flat(tb, j_idx), jnp.asarray(table))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(vjp(j_cot)[0]), rtol=1e-5, atol=1e-5)


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, table, idx):
        self.calls.append((tuple(table.shape), idx.dtype, table.is_contiguous() and idx.is_contiguous()))
        return table.new_empty((table.shape[0], idx.shape[1], table.shape[2]))


@pytest.mark.parametrize("channels", [9, 16, 40, 184])
def test_default_dispatch_and_env(no_override, monkeypatch, channels):
    """One rule: a table that is not on the CPU goes to `gather_rows` whatever
    its width (int32 contiguous indices), a CPU table to the plain version;
    the one switch forces the plain version; the environment is not read."""
    kernel, plain = _Recorder(), _Recorder()
    monkeypatch.setattr(tsamp, "gather_rows", kernel)
    monkeypatch.setattr(tsamp, "gather_rows_ref", plain)
    monkeypatch.setenv("ANYSTEREO_GATHER_IMPL", "torch")
    off_cpu = torch.zeros(2, 30, channels, device="meta")
    idx = torch.zeros(2, 7, dtype=torch.int64, device="meta")
    tsamp.gather_rows_flat(off_cpu.transpose(0, 1).contiguous().transpose(0, 1), idx)
    assert kernel.calls == [((2, 30, channels), torch.int32, True)] and plain.calls == []
    tsamp.gather_rows_flat(torch.zeros(2, 30, channels), torch.zeros(2, 7, dtype=torch.int64))
    assert len(kernel.calls) == 1 and len(plain.calls) == 1
    tsamp.set_gather_plain(True)
    tsamp.gather_rows_flat(off_cpu, idx)
    assert len(kernel.calls) == 1 and len(plain.calls) == 2
    tsamp.set_gather_plain(False)
    tsamp.gather_rows_flat(off_cpu, idx)
    assert len(kernel.calls) == 2
    for gone in ("GATHER_IMPLS", "set_gather_override", "_gather_impl", "gather_rows_hybrid"):
        assert not hasattr(tsamp, gone)


@pytest.mark.parametrize("plain", [False, True])
def test_nearest_sample_matches_jax(rng, no_override, plain):
    feat = rng.randn(2, 12, 17, 9).astype(np.float32)
    coords = ((rng.rand(2, 83, 2) * 2 - 1) * 0.98).astype(np.float32)
    coords[0, :3] = [[-1 + 1e-6, 1 - 1e-6], [0.0, 0.0], [1 - 1e-6, -1 + 1e-6]]
    tsamp.set_gather_plain(plain)
    want = jsamp.nearest_sample(jnp.asarray(feat), jnp.asarray(coords))
    got = tsamp.nearest_sample(torch.from_numpy(feat), torch.from_numpy(coords))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nearest_latent_coords_matches_jax(rng):
    coords = (rng.rand(2, 200, 2) * 2 - 1).astype(np.float32)
    want = jsamp.nearest_latent_coords(jnp.asarray(coords), 12, 17)
    got = tsamp.nearest_latent_coords(torch.from_numpy(coords), 12, 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
