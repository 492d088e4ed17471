"""The port's window-pyramid lookups (`ops/kernels/lookup_window.py`) and the
"classify" flavor of `pyramid_lookup` vs the JAX package.

The JAX side runs as `tests/test_pallas.py` runs it: the Pallas kernels
`gather_pyramid_window_pm`, `gather_pyramid_window_t` and
`gather_pyramid_window` in interpret mode, forward and `jax.vjp`.  On the CPU
the port's wrappers take their plain versions through the same
`torch.autograd.Function`s that launch the CUDA kernels on the card
(`tests/test_torch_cuda.py` and `chip_smoke.py` hold those kernels to these
plain versions, bit for bit), so what is held here is the arithmetic: the
shared fractional weight, sum-then-scale pooling, floor truncation of odd
tails, unclamped bases.

Tolerance: fp32, 1e-5 absolute + 1e-5 relative.  The two sides sum a cell's
2^lvl entries (forward) and a gradient entry's `levels` terms (backward) in
another order; nothing else differs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anystereo_tpu.ops import lookup as jlk
from anystereo_tpu.ops.pallas import lookup_kernel as jk
from anystereo_tpu_torch.ops import lookup as tlk
from anystereo_tpu_torch.ops.kernels import lookup_window as tw

RTOL = ATOL = 1e-5
TAPS = 9
FAR = (-1e6, 1e6, -3e9, 3e9, -60.0, 400.0)

# name: (port function, port backward, JAX kernel, volume is [L, R], output is [C, R])
LAYOUTS = {
    "pm": (tw.gather_pyramid_window_pm, tw.gather_pyramid_window_pm_bwd,
           jk.gather_pyramid_window_pm, True, False),
    "t": (tw.gather_pyramid_window_t, tw.gather_pyramid_window_t_bwd,
          jk.gather_pyramid_window_t, True, True),
    "rows": (tw.gather_pyramid_window, tw.gather_pyramid_window_bwd,
             jk.gather_pyramid_window, False, False),
}


def _inputs(rng, layout, r, length, levels, taps=TAPS):
    """Row-major numpy operands and their views in `layout`: windows inside
    the row, hanging over both ends, and far outside at both signs."""
    vol = rng.randn(r, length).astype(np.float32)
    bases = np.stack([rng.rand(r) * ((length >> lvl) + 16) - 10 for lvl in range(levels)], 1)
    bases = bases.astype(np.float32)
    bases[: len(FAR)] = np.asarray(FAR, np.float32)[:, None]
    g = rng.randn(r, levels * taps).astype(np.float32)
    _, _, _, vol_t, out_t = LAYOUTS[layout]
    tr = (lambda a: np.ascontiguousarray(a.T))
    return (tr(vol) if vol_t else vol, tr(bases) if vol_t else bases, tr(g) if out_t else g)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("length", [21, 39, 48, 80])
def test_forward_and_vjp_match_tpu_kernel(rng, layout, levels, length):
    fn, _, jfn, _, _ = LAYOUTS[layout]
    vol, bases, g = _inputs(rng, layout, 24, length, levels)
    want, vjp = jax.vjp(lambda v: jfn(v, jnp.asarray(bases), TAPS, True), jnp.asarray(vol))
    v = torch.from_numpy(vol).requires_grad_(True)
    got = fn(v, torch.from_numpy(bases), TAPS)
    got.backward(torch.from_numpy(g))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert v.grad.shape == v.shape and v.grad.dtype == torch.float32
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_far_bases_give_zero_rows_and_zero_gradients(rng, layout):
    """Bases are not clamped by the caller: ±1e6 and ±3e9 (beyond int32) and
    windows wholly outside the row give all-zero taps, and a written zero
    gradient."""
    fn, _, _, vol_t, out_t = LAYOUTS[layout]
    vol, bases, g = _inputs(rng, layout, 16, 48, 3)
    v = torch.from_numpy(vol).requires_grad_(True)
    out = fn(v, torch.from_numpy(bases), TAPS)
    out.backward(torch.from_numpy(g))
    rows_out = out.detach().t() if out_t else out.detach()
    rows_grad = v.grad.t() if vol_t else v.grad
    assert torch.isfinite(out).all() and not rows_out[: len(FAR)].any()
    assert not rows_grad[: len(FAR)].any() and rows_grad[len(FAR):].any()


@pytest.mark.parametrize("length,levels", [(21, 3), (39, 4), (80, 4), (5, 4)])
def test_odd_tails_and_empty_levels(rng, length, levels):
    """Entries j >= (L >> lvl) << lvl give nothing to level lvl and get
    nothing from it; a level with L >> lvl == 0 is all zeros."""
    r = 12
    vol = rng.randn(r, length).astype(np.float32)
    bases = np.zeros((r, levels), np.float32)  # windows start at cell 0 of every level
    bases += rng.rand(r, 1).astype(np.float32)
    g = np.zeros((r, levels * TAPS), np.float32)
    top = levels - 1
    g[:, top * TAPS:] = 1.0  # cotangent on the coarsest level only
    v = torch.from_numpy(vol).requires_grad_(True)
    out = tw.gather_pyramid_window(v, torch.from_numpy(bases), TAPS)
    out.backward(torch.from_numpy(g))
    n = length >> top
    if n == 0:
        assert not out[:, top * TAPS:].any() and not v.grad.any()
    else:
        assert v.grad[:, : n << top].any()
        assert not v.grad[:, n << top:].any()
        changed = vol.copy()
        changed[:, n << top:] += 100.0  # the tail never reaches the coarsest level
        again = tw.gather_pyramid_window_ref(torch.from_numpy(changed), torch.from_numpy(bases), TAPS)
        assert torch.equal(again[:, top * TAPS:], out.detach()[:, top * TAPS:])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("levels,length,taps", [(1, 48, 9), (3, 39, 9), (4, 80, 5)])
def test_plain_backward_is_autograd_of_plain_forward(rng, layout, levels, length, taps):
    """Each `*_bwd_ref` against PyTorch's own autograd of the forward's plain
    version (1e-6: both sum the same few products)."""
    fn, bwd, _, vol_t, _ = LAYOUTS[layout]
    ref = getattr(tw, fn.__name__ + "_ref")
    vol, bases, g = _inputs(rng, layout, 20, length, levels, taps)
    v = torch.from_numpy(vol).requires_grad_(True)
    ref(v, torch.from_numpy(bases), taps).backward(torch.from_numpy(g))
    got = bwd(torch.from_numpy(bases), torch.from_numpy(g), length, taps)
    assert got.shape == v.shape
    torch.testing.assert_close(got, v.grad, rtol=1e-6, atol=1e-6)


def test_layouts_agree_exactly(rng):
    """The three layouts are one function: `_t` is `_pm` transposed and the
    row-major one is `_pm` on transposed inputs, bit for bit."""
    vol, bases, g = _inputs(rng, "rows", 33, 39, 4)
    tv, tb, tg = (torch.from_numpy(a) for a in (vol, bases, g))
    rows = tw.gather_pyramid_window(tv, tb, TAPS)
    pm = tw.gather_pyramid_window_pm(tv.t().contiguous(), tb.t().contiguous(), TAPS)
    tt = tw.gather_pyramid_window_t(tv.t().contiguous(), tb.t().contiguous(), TAPS)
    assert torch.equal(rows, pm) and torch.equal(tt.t(), pm)
    d_rows = tw.gather_pyramid_window_bwd(tb, tg, 39, TAPS)
    d_pm = tw.gather_pyramid_window_pm_bwd(tb.t().contiguous(), tg, 39, TAPS)
    d_t = tw.gather_pyramid_window_t_bwd(tb.t().contiguous(), tg.t().contiguous(), 39, TAPS)
    assert torch.equal(d_rows.t(), d_pm) and torch.equal(d_t, d_pm)


def test_cpu_takes_plain_versions_and_counts_no_launch(rng):
    fns = [f for pair in LAYOUTS.values() for f in pair[:2]]
    before = [f.launches for f in fns]
    for layout, (fn, _, _, _, _) in LAYOUTS.items():
        vol, bases, g = _inputs(rng, layout, 10, 48, 2)
        v = torch.from_numpy(vol).requires_grad_(True)
        xb = torch.from_numpy(bases).requires_grad_(True)
        out = fn(v, xb, TAPS)
        out.backward(torch.from_numpy(g))
        assert torch.equal(out, getattr(tw, fn.__name__ + "_ref")(v.detach(), xb.detach(), TAPS))
        assert xb.grad is None and v.grad is not None  # bases get no gradient
    assert [f.launches for f in fns] == before


@pytest.mark.parametrize("bad", ["dtype", "rows", "levels", "taps", "rank", "device", "g_shape"])
def test_wrappers_reject_bad_input(bad):
    vol_t, bases_t, taps = torch.zeros(16, 4), torch.zeros(2, 4), 9
    g = torch.zeros(4, 18)
    if bad == "dtype":
        vol_t = vol_t.double()
    elif bad == "rows":
        bases_t = torch.zeros(2, 5)
    elif bad == "levels":
        bases_t, g = torch.zeros(6, 4), torch.zeros(4, 54)
    elif bad == "taps":
        taps, g = 0, torch.zeros(4, 0)
    elif bad == "rank":
        vol_t = torch.zeros(16)
    elif bad == "device":
        vol_t, bases_t, g = vol_t.to("meta"), bases_t.to("meta"), g.to("meta")
    else:
        g = torch.zeros(4, 17)
    if bad != "g_shape":
        with pytest.raises((TypeError, ValueError, RuntimeError)):
            tw.gather_pyramid_window_pm(vol_t, bases_t, taps)
    if bad in ("levels", "taps", "device", "g_shape"):
        with pytest.raises((TypeError, ValueError, RuntimeError)):
            tw.gather_pyramid_window_pm_bwd(bases_t, g, 16, taps)


# ------------------------------------------------- pyramid_lookup, classify


def _pyramids(rng, core, b=2, h=3, w=24, g=4, d=16, radius=4):
    levels = 2 if core == "igev" else 4
    corr = rng.randn(b, h, w, w).astype(np.float32)
    geo = rng.randn(b, h, w, g, d).astype(np.float32) if core == "igev" else None
    disp = (rng.rand(b, h, w) * (d + 8) - 4).astype(np.float32)
    jgeo = None if geo is None else jnp.asarray(geo)
    tgeo = None if geo is None else torch.from_numpy(geo)
    return (jlk.build_pyramid(jnp.asarray(corr), jgeo, levels, radius),
            tlk.build_pyramid(torch.from_numpy(corr), tgeo, levels, radius), disp)


@pytest.fixture
def jax_classify(monkeypatch):
    """The JAX `pyramid_lookup` forced to the classify flavor with its Pallas
    kernel in interpret mode, as `tests/test_pallas.py` forces it."""
    monkeypatch.setenv("ANYSTEREO_LOOKUP_KERNEL", "classify")
    orig = jk.gather_pyramid_window_pm
    monkeypatch.setattr(jk, "gather_pyramid_window_pm",
                        lambda vol, bases, taps, interp=False: orig(vol, bases, taps, True))


@pytest.mark.parametrize("core", ["igev", "raft"])
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_pyramid_lookup_classify_matches_jax(rng, jax_classify, core, split, out_dtype):
    jp, tp, disp = _pyramids(rng, core)
    jdt, tdt = (jnp.float32, torch.float32) if out_dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = jlk.pyramid_lookup(jp, jnp.asarray(disp), impl="pallas", split=split, out_dtype=jdt)
    got = tlk.pyramid_lookup(tp, torch.from_numpy(disp), split=split, out_dtype=tdt, kernel="classify")
    want, got = (want, got) if split else ((want,), (got,))
    assert len(got) == len(want) == (1 if not split or core == "raft" else 2)
    for a, b in zip(got, want):
        assert a.dtype == tdt and tuple(a.shape) == b.shape
        b = np.asarray(b).astype(np.float32)
        if out_dtype == "float32":
            np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL)
        else:  # one rounding of fp32 results that agree to 1e-5: one bf16 ulp
            assert np.all(np.abs(a.float().numpy() - b) <= np.abs(b) * 2.0 ** -7 + 2e-5)


@pytest.mark.parametrize("core", ["igev", "raft"])
def test_classify_flavor_agrees_with_aligned_and_its_gradient(rng, core):
    """The two flavors compute the same lookup (weights rounded per level
    against per tap: 1e-4 relative, 1e-5 absolute), forward and in the
    gradient of both volumes; the transposed copies are made once a pyramid."""
    _, tp, disp = _pyramids(rng, core)
    vols = [v.requires_grad_(True) for v in (tp.corr, tp.geo) if v is not None]
    cot, grads = None, {}
    for kernel in tlk.LOOKUP_KERNELS:
        out = tlk.pyramid_lookup(tp, torch.from_numpy(disp), kernel=kernel)
        out = out + tlk.pyramid_lookup(tp, torch.from_numpy(disp) + 0.37, kernel=kernel)
        cot = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)) if cot is None else cot
        grads[kernel] = (out.detach(), torch.autograd.grad(out, vols, cot))
    assert sorted(tp._transposed) == (["corr", "geo"] if core == "igev" else ["corr"])
    assert all(t.is_contiguous() and t.shape[0] == getattr(tp, n).shape[-1]
               for n, t in tp._transposed.items())
    (oa, ga), (oc, gc) = grads["aligned"], grads["classify"]
    torch.testing.assert_close(oc, oa, rtol=1e-4, atol=1e-5)
    for a, c in zip(ga, gc):
        torch.testing.assert_close(c, a, rtol=1e-4, atol=1e-5)


def test_flavor_selector(rng, monkeypatch):
    """`kernel=` wins; without it the process default is read from
    ANYSTEREO_LOOKUP_KERNEL at each call; an unknown name raises."""
    _, tp, disp = _pyramids(rng, "raft")
    calls = []

    def spy(name, fn):
        def wrapped(*args):
            calls.append(name)
            return fn(*args)
        return wrapped

    monkeypatch.setattr(tlk, "gather_pyramid_window_pm", spy("classify", tlk.gather_pyramid_window_pm))
    monkeypatch.setattr(tlk, "gather_pyramid_aligned", spy("aligned", tlk.gather_pyramid_aligned))
    d = torch.from_numpy(disp)
    monkeypatch.delenv("ANYSTEREO_LOOKUP_KERNEL", raising=False)
    assert tlk.default_lookup_kernel() == "aligned"
    tlk.pyramid_lookup(tp, d)
    tlk.pyramid_lookup(tp, d, kernel="classify")
    monkeypatch.setenv("ANYSTEREO_LOOKUP_KERNEL", "classify")
    tlk.pyramid_lookup(tp, d)
    tlk.pyramid_lookup(tp, d, kernel="aligned")
    assert calls == ["aligned", "classify", "classify", "aligned"]
    with pytest.raises(ValueError):
        tlk.pyramid_lookup(tp, d, kernel="barrel")
    monkeypatch.setenv("ANYSTEREO_LOOKUP_KERNEL", "pallas")
    with pytest.raises(ValueError):
        tlk.pyramid_lookup(tp, d)

