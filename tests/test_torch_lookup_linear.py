"""The single-level linear lookups of the PyTorch port vs the JAX package:
`gather_rows_linear` (arbitrary positions) and `gather_window_linear` (a
window of consecutive taps from one start a row), forward and backward, and
the per-level flavor of `pyramid_lookup` that is built on the second.

On the CPU the port's wrappers take their plain versions, which is what
these tests hold: against the Pallas kernels in interpret mode (as
`tests/test_pallas.py` runs them), against the jnp oracle
`gather_1d_linear`, and the backwards against `jax.vjp`.  Tolerances are
those of `tests/test_pallas.py`: forward rtol/atol 1e-5, backward rtol 1e-4 /
atol 1e-5 (the window form weighs with `base - floor(base)`, the oracle with
`(base + k) - floor(base + k)`; the two differ by the rounding of `base + k`).
`pyramid_lookup(kernel="levels")` follows the JAX `impl="jnp"` branch
operation for operation (stored pooled levels, no clamp of the positions) and
is held to it at 1e-5; against the port's "aligned" flavor, which clamps and
pools inside its kernel, it is held on in-range positions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anystereo_tpu.ops import lookup as jlookup
from anystereo_tpu.ops.pallas import lookup_kernel as jk
from anystereo_tpu.ops.sampling import gather_1d_linear as jax_gather_1d_linear
from anystereo_tpu_torch.ops import lookup as tlookup
from anystereo_tpu_torch.ops import sampling as tsamp
from anystereo_tpu_torch.ops.kernels import lookup_linear as tl

FWD = dict(rtol=1e-5, atol=1e-5)
BWD = dict(rtol=1e-4, atol=1e-5)
FAR = (-3e9, 3e9, -1e6, 1e6)

# (R, L, K): the shapes of tests/test_pallas.py and the odd level lengths
ROWS_SHAPES = [(10, 48, 9), (300, 312, 9), (7, 24, 5), (12, 40, 9), (9, 39, 9), (6, 78, 9),
               (5, 156, 7), (4, 33, 40)]
WINDOW_SHAPES = [(50, 48, 9), (12, 32, 9), (11, 39, 9), (8, 78, 9), (6, 156, 9), (7, 24, 5),
                 (300, 312, 9)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows_inputs(rng, r, l, k):
    vol = rng.randn(r, l).astype(np.float32)
    pos = (rng.rand(r, k).astype(np.float32) * (l + 8)) - 4
    pos[0, : min(k, 4)] = FAR[: min(k, 4)]
    pos[1, 0], pos[1, 1] = -1.0, l - 1.0  # only the upper / only the lower neighbour in range
    pos[2, : min(k, 3)] = (0.0, 3.0, l - 2.0)[: min(k, 3)]  # integer positions
    g = rng.randn(r, k).astype(np.float32)
    return vol, pos, g


def _window_inputs(rng, r, l, k):
    vol = rng.randn(r, l).astype(np.float32)
    base = (rng.rand(r).astype(np.float32) * (l + 2 * k)) - k
    base[:4] = FAR
    base[4], base[5] = -1.0, float(l - k)  # integer starts at both edges
    g = rng.randn(r, k).astype(np.float32)
    return vol, base, g


# ----------------------------------------------------------- gather_rows_linear


@pytest.mark.parametrize("r,l,k", ROWS_SHAPES)
def test_rows_forward_matches_pallas_and_oracle(rng, r, l, k):
    vol, pos, _ = _rows_inputs(rng, r, l, k)
    before = tl.gather_rows_linear.launches
    got = tl.gather_rows_linear(_t(vol), _t(pos))
    assert tl.gather_rows_linear.launches == before  # the CPU takes the plain version
    assert got.dtype == torch.float32 and got.shape == (r, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(jk.gather_rows_linear(vol, pos, True)), **FWD)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_gather_1d_linear(vol, pos)), **FWD)
    assert not got[0, : min(k, 4)].any()  # far positions: exact zeros
    np.testing.assert_array_equal(got[2, : min(k, 3)].numpy(),
                                  vol[2, [0, 3, l - 2][: min(k, 3)]])  # integers: the entry itself


@pytest.mark.parametrize("r,l,k", ROWS_SHAPES)
def test_rows_backward_matches_vjp(rng, r, l, k):
    vol, pos, g = _rows_inputs(rng, r, l, k)
    _, vjp = jax.vjp(lambda v: jk.gather_rows_linear(v, jnp.asarray(pos), True), jnp.asarray(vol))
    (want,) = vjp(jnp.asarray(g))
    (oracle,) = jax.vjp(lambda v: jax_gather_1d_linear(v, jnp.asarray(pos)), jnp.asarray(vol))[1](
        jnp.asarray(g))
    got = tl.gather_rows_linear_bwd(_t(pos), _t(g), l)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BWD)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **BWD)
    # the same through autograd, and the plain forward under PyTorch's own
    v = _t(vol).requires_grad_(True)
    tl.gather_rows_linear(v, _t(pos)).backward(_t(g))
    assert torch.equal(v.grad, got)
    v2 = _t(vol).requires_grad_(True)
    tl.gather_rows_linear_ref(v2, _t(pos)).backward(_t(g))
    np.testing.assert_allclose(v2.grad.numpy(), got.numpy(), rtol=1e-5, atol=1e-6)


def test_rows_duplicate_positions_sum(rng):
    """Many taps on one entry: the gradient is their sum."""
    vol = rng.randn(2, 16).astype(np.float32)
    pos = np.full((2, 40), 5.25, np.float32)
    g = rng.randn(2, 40).astype(np.float32)
    got = tl.gather_rows_linear_bwd(_t(pos), _t(g), 16).numpy()
    want = np.zeros((2, 16), np.float32)
    want[:, 5], want[:, 6] = 0.75 * g.sum(1), 0.25 * g.sum(1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_positions_get_no_gradient(rng):
    vol, pos, g = _rows_inputs(rng, 6, 20, 5)
    p = _t(pos).requires_grad_(True)
    v = _t(vol).requires_grad_(True)
    tl.gather_rows_linear(v, p).backward(_t(g))
    assert p.grad is None and v.grad is not None
    base = _t(pos[:, 0]).requires_grad_(True)
    tl.gather_window_linear(v, base, 5).sum().backward()
    assert base.grad is None
    # the public function refuses such positions (its JAX twin differentiates
    # them; the port does not) and takes them detached or under no_grad
    with pytest.raises(ValueError, match="no gradient to `pos`"):
        tsamp.gather_1d_linear(v, p)
    tsamp.gather_1d_linear(v, p.detach()).sum().backward()
    with torch.no_grad():
        tsamp.gather_1d_linear(v, p)
    assert p.grad is None


@pytest.mark.parametrize("shape", [(2, 3, 16), (1, 4, 5, 2, 8)])
def test_gather_1d_linear_leading_axes(rng, shape):
    """`ops/sampling.gather_1d_linear` over any leading axes, vs the oracle."""
    vol = rng.randn(*shape).astype(np.float32)
    pos = (rng.rand(*shape[:-1], 7) * (shape[-1] + 4) - 2).astype(np.float32)
    got = tsamp.gather_1d_linear(_t(vol), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_gather_1d_linear(vol, pos)), **FWD)


def test_wrappers_reject_bad_operands(rng):
    vol, pos, g = _rows_inputs(rng, 6, 20, 5)
    with pytest.raises(TypeError):
        tl.gather_rows_linear(_t(vol).double(), _t(pos))
    with pytest.raises(ValueError):
        tl.gather_rows_linear(_t(vol), _t(pos[:3]))
    with pytest.raises(ValueError):
        tl.gather_rows_linear_bwd(_t(pos), _t(g[:, :2]), 20)
    with pytest.raises(ValueError):
        tl.gather_window_linear(_t(vol), _t(pos), 5)  # window starts are [R]
    with pytest.raises(ValueError):
        tl.gather_window_linear_bwd(_t(pos[:, 0]), _t(g), 20, 9)
    with pytest.raises(RuntimeError):
        tl.gather_rows_linear(_t(vol).to("meta"), _t(pos).to("meta"))


# --------------------------------------------------------- gather_window_linear


@pytest.mark.parametrize("r,l,k", WINDOW_SHAPES)
def test_window_forward_matches_pallas_and_oracle(rng, r, l, k):
    vol, base, _ = _window_inputs(rng, r, l, k)
    before = tl.gather_window_linear.launches
    got = tl.gather_window_linear(_t(vol), _t(base), k)
    assert tl.gather_window_linear.launches == before
    assert got.dtype == torch.float32 and got.shape == (r, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(jk.gather_window_linear(vol, base, k, True)),
                               **FWD)
    pos = base[:, None] + np.arange(k, dtype=np.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_gather_1d_linear(vol, pos)), **FWD)
    # and the port's two plain versions against each other
    np.testing.assert_allclose(got.numpy(), tl.gather_rows_linear_ref(_t(vol), _t(pos)).numpy(), **FWD)
    assert not got[:4].any()
    np.testing.assert_array_equal(got[4, 1:].numpy(), vol[4, : k - 1])  # base -1: tap 0 is outside
    assert got[4, 0] == 0
    np.testing.assert_array_equal(got[5].numpy(), vol[5, l - k:])


@pytest.mark.parametrize("r,l,k", WINDOW_SHAPES)
def test_window_backward_matches_vjp(rng, r, l, k):
    vol, base, g = _window_inputs(rng, r, l, k)
    _, vjp = jax.vjp(lambda v: jk.gather_window_linear(v, jnp.asarray(base), k, True),
                     jnp.asarray(vol))
    (want,) = vjp(jnp.asarray(g))
    got = tl.gather_window_linear_bwd(_t(base), _t(g), l, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BWD)
    assert not got[:4].any()
    v = _t(vol).requires_grad_(True)
    tl.gather_window_linear(v, _t(base), k).backward(_t(g))
    assert torch.equal(v.grad, got)
    v2 = _t(vol).requires_grad_(True)
    tl.gather_window_linear_ref(v2, _t(base), k).backward(_t(g))
    np.testing.assert_allclose(v2.grad.numpy(), got.numpy(), rtol=1e-5, atol=1e-6)


# ------------------------------------------------ pyramid_lookup(kernel="levels")

CORES = {"igev": dict(levels=2, groups=2, d=12), "raft": dict(levels=4, groups=None, d=None)}


def _pyramids(rng, core, w=18, far=True):
    c = CORES[core]
    b, h, radius = 1, 3, 4
    corr = rng.randn(b, h, w, w).astype(np.float32)
    geo = None if c["groups"] is None else rng.randn(b, h, w, c["groups"], c["d"]).astype(np.float32)
    top = (c["d"] or w) - 1
    disp = (rng.rand(b, h, w) * top).astype(np.float32)
    if far:
        disp[0, 0, :4] = (-3e9, 3e9, -40.0, 500.0)
    jp = jlookup.build_pyramid(jnp.asarray(corr), None if geo is None else jnp.asarray(geo),
                               c["levels"], radius)
    tp = tlookup.build_pyramid(_t(corr), None if geo is None else _t(geo), c["levels"], radius)
    return jp, tp, disp


@pytest.mark.parametrize("core", ["igev", "raft"])
@pytest.mark.parametrize("split,out_dtype", [(False, None), (True, None), (True, "bfloat16"),
                                             (False, "bfloat16")])
def test_levels_flavor_matches_jax_jnp_impl(rng, core, split, out_dtype):
    jp, tp, disp = _pyramids(rng, core)
    jdt, tdt = (None, None) if out_dtype is None else (jnp.bfloat16, torch.bfloat16)
    want = jlookup.pyramid_lookup(jp, jnp.asarray(disp), impl="jnp", split=split, out_dtype=jdt)
    before = tl.gather_window_linear.launches
    got = tlookup.pyramid_lookup(tp, _t(disp), split=split, out_dtype=tdt, kernel="levels")
    assert tl.gather_window_linear.launches == before
    want, got = (want, got) if split else ((want,), (got,))
    assert len(want) == len(got) == ((2 if core == "igev" else 1) if split else 1)
    for w_, g_ in zip(want, got):
        assert g_.dtype == (tdt or torch.float32) and tuple(g_.shape) == w_.shape
        tol = FWD if out_dtype is None else dict(rtol=1e-2, atol=1e-5)  # one bf16 rounding
        np.testing.assert_allclose(g_.float().numpy(), np.asarray(w_.astype(jnp.float32)), **tol)
    assert tp.out_channels == sum(g_.shape[-1] for g_ in got)


@pytest.mark.parametrize("core", ["igev", "raft"])
def test_levels_flavor_with_coords_and_env(rng, core, monkeypatch):
    jp, tp, disp = _pyramids(rng, core)
    coords = (np.arange(disp.shape[-1], dtype=np.float32) + 2.5)
    want = jlookup.pyramid_lookup(jp, jnp.asarray(disp), coords=jnp.asarray(coords), impl="jnp")
    monkeypatch.setenv("ANYSTEREO_LOOKUP_KERNEL", "levels")
    got = tlookup.pyramid_lookup(tp, _t(disp), coords=_t(coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    assert "levels" in tlookup.LOOKUP_KERNELS
    with pytest.raises(ValueError):
        tlookup.pyramid_lookup(tp, _t(disp), kernel="level")


@pytest.mark.parametrize("core", ["igev", "raft"])
@pytest.mark.parametrize("w", [16, 18])
def test_levels_flavor_matches_aligned_in_range(rng, core, w):
    """Positions inside the rows: the stored pooled levels and the pooling
    inside the aligned kernel's plain version are the same numbers."""
    _, tp, disp = _pyramids(rng, core, w=w, far=False)
    a = tlookup.pyramid_lookup(tp, _t(disp), kernel="aligned")
    b = tlookup.pyramid_lookup(tp, _t(disp), kernel="levels")
    np.testing.assert_allclose(b.numpy(), a.numpy(), **FWD)
    assert len(tp.levels("corr")) == CORES[core]["levels"]
    assert tp.levels("corr") is tp.levels("corr")  # made once, kept


@pytest.mark.parametrize("core", ["igev", "raft"])
def test_levels_flavor_gradients_match_jax(rng, core):
    """d/d(volumes) of a weighted sum of the lookup, through the stored
    levels and their pooling, against `jax.grad` of the jnp branch."""
    c = CORES[core]
    jp, tp, disp = _pyramids(rng, core)
    ch = tp.out_channels
    wts = rng.randn(*disp.shape, ch).astype(np.float32)
    corr0 = np.asarray(jp.corr_levels[0])
    geo0 = None if c["groups"] is None else np.asarray(jp.geo_levels[0])

    def loss(corr, geo):
        p = jlookup.build_pyramid(corr, geo, c["levels"], 4)
        return (jlookup.pyramid_lookup(p, jnp.asarray(disp), impl="jnp") * wts).sum()

    argnums = (0,) if geo0 is None else (0, 1)
    want = jax.grad(loss, argnums)(jnp.asarray(corr0), None if geo0 is None else jnp.asarray(geo0))
    tc = _t(corr0).requires_grad_(True)
    tg = None if geo0 is None else _t(geo0).requires_grad_(True)
    before = tl.gather_window_linear_bwd.launches
    pyr = tlookup.build_pyramid(tc, tg, c["levels"], 4)
    (tlookup.pyramid_lookup(pyr, _t(disp), kernel="levels") * _t(wts)).sum().backward()
    assert tl.gather_window_linear_bwd.launches == before
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(want[0]), **BWD)
    if tg is not None:
        np.testing.assert_allclose(tg.grad.numpy(), np.asarray(want[1]), **BWD)
