"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests import neither JAX nor the JAX package, so they run on a
machine that has only PyTorch and a card:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a card they skip: a CUDA kernel has no CPU mode.  `chip_smoke.py`
holds the same kernels to their plain versions at the main-path shapes.
"""

import pytest
import torch

from anystereo_tpu_torch.config import ModelConfig, TrainConfig, raft_config
from anystereo_tpu_torch.nn.model import build_model
from anystereo_tpu_torch.eval.occlusion import occ_mask
from anystereo_tpu_torch.ops import lookup, sampling
from anystereo_tpu_torch.ops.kernels import lookup_linear as tl
from anystereo_tpu_torch.ops.kernels import lookup_window as tw
from anystereo_tpu_torch.ops.kernels.gather import (
    gather_rows,
    gather_rows_hybrid,
    gather_rows_ref,
    scatter_rows_add,
    scatter_rows_add_ref,
    scatter_vec,
)
from anystereo_tpu_torch.ops.kernels.lookup import (
    gather_pyramid_aligned,
    gather_pyramid_aligned_bwd,
    gather_pyramid_aligned_bwd_ref,
    gather_pyramid_aligned_ref,
)
from anystereo_tpu_torch.ops.sampling import set_gather_plain
from anystereo_tpu_torch.train.step import loss_and_metrics

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # cuDNN's non-deterministic backward algorithms move some gradients by up
    # to 1e-2 between two runs of the same path, far above the tolerances here
    torch.backends.cudnn.deterministic = True
    return torch.device("cuda")


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_lookup_kernel_matches_plain_version(card, levels, out_dtype):
    """The kernel repeats the plain version's fp32 roundings, so the fp32
    results agree to 1e-5 and the bf16 ones (one rounding each) to 1e-5
    after that rounding."""
    g = torch.Generator(device=card).manual_seed(0)
    for rows, length in ((4096, 48), (1024, 312), (777, 45)):
        vol = torch.randn(rows, length, device=card, generator=g)
        x = torch.rand(rows, device=card, generator=g) * (length + 80) - 40
        x[:4] = torch.tensor([-1e6, 1e6, -3e4, 2.5e3], device=card)
        before = gather_pyramid_aligned.launches
        got = gather_pyramid_aligned(vol, x, 9, levels, out_dtype)
        want = gather_pyramid_aligned_ref(vol, x, 9, levels, out_dtype)
        torch.cuda.synchronize()
        assert gather_pyramid_aligned.launches == before + 1
        assert got.dtype == out_dtype and got.shape == (rows, levels * 9)
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=1e-5)


# rows off the forward's tile of 32 / 16 / 8 rows, lengths whose rows are
# not 16-byte aligned (5, 45) or are (48, 80, 312)
_TILE_CASES = [(33, 5), (777, 45), (239616 + 5, 48), (1000, 80), (777, 312), (33, 312)]


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_lookup_kernel_tile_edges(card, levels, out_dtype):
    """The edges of the tiled forward: partial last tiles, any length, an
    offset view of `vol` whose address is only 4-byte aligned, runs of 8
    rows that share x (the GEV volume's groups), far positions, the models'
    9 taps (unrolled) and 7 (the general walk); within 1e-5 of the plain
    version, one launch a call."""
    g = torch.Generator(device=card).manual_seed(4)
    for (rows, length), taps in [(case, 9) for case in _TILE_CASES] + [((777, 45), 7), ((1000, 80), 7)]:
        buf = torch.randn(rows * length + 1, device=card, generator=g)
        x = torch.rand(rows, device=card, generator=g) * (length + 80) - 40
        x[:4] = torch.tensor([-1e6, 1e6, -3e4, 2.5e3], device=card)
        shared = rows // 16 * 8  # the second half of the rows in runs of 8
        x[rows - shared:] = x[rows - shared:: 8].repeat_interleave(8)
        for vol in (buf[:-1].view(rows, length), buf[1:].view(rows, length)):
            want = gather_pyramid_aligned_ref(vol, x, taps, levels, out_dtype)
            before = gather_pyramid_aligned.launches
            got = gather_pyramid_aligned(vol, x, taps, levels, out_dtype)
            torch.cuda.synchronize()
            assert gather_pyramid_aligned.launches == before + 1
            assert got.dtype == out_dtype and got.shape == (rows, levels * taps)
            torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=1e-5)


def test_eval_forward_through_kernel(card, monkeypatch):
    """A small fp32 forward launches the kernel twice per GRU iteration and
    agrees with the same forward through the plain lookup to 1e-3 px."""
    model = build_model(ModelConfig(max_disp=32, compute_dtype="float32"), device=card, seed=0)
    g = torch.Generator(device=card).manual_seed(1)
    left = torch.rand(1, 64, 128, 3, device=card, generator=g) * 255
    right = torch.roll(left, shifts=-4, dims=2)
    before = gather_pyramid_aligned.launches
    out = model(left, right, iters=3)
    torch.cuda.synchronize()
    assert gather_pyramid_aligned.launches == before + 6
    assert out.disp_final.shape == (1, 64, 128) and torch.isfinite(out.disp_final).all()
    monkeypatch.setattr(lookup, "gather_pyramid_aligned", gather_pyramid_aligned_ref)
    plain = model(left, right, iters=3)
    torch.testing.assert_close(out.disp_final, plain.disp_final, rtol=0, atol=1e-3)


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_lookup_backward_kernel_matches_plain_version(card, levels, g_dtype):
    """The backward kernel repeats the plain version's operations in its
    order (taps ascending, lower cell before upper, levels ascending, no
    FMA), so the two agree exactly; rows far outside get written zeros."""
    g = torch.Generator(device=card).manual_seed(0)
    for rows, length in ((4096, 48), (1024, 80), (777, 45), (33, 5)):
        x = torch.rand(rows, device=card, generator=g) * (length + 80) - 40
        x[:4] = torch.tensor([-1e6, 1e6, -3e4, 2.5e3], device=card)
        cot = torch.randn(rows, levels * 9, device=card, generator=g).to(g_dtype)
        before = gather_pyramid_aligned_bwd.launches
        got = gather_pyramid_aligned_bwd(x, cot, length, 9, levels)
        want = gather_pyramid_aligned_bwd_ref(x, cot, length, 9, levels)
        torch.cuda.synchronize()
        assert gather_pyramid_aligned_bwd.launches == before + 1
        assert got.dtype == torch.float32 and got.shape == (rows, length)
        assert torch.equal(got, want)
        assert not got[:4].any()


def test_lookup_is_differentiable_through_the_kernels(card):
    g = torch.Generator(device=card).manual_seed(1)
    vol = torch.randn(2048, 48, device=card, generator=g, requires_grad=True)
    x = torch.rand(2048, device=card, generator=g) * 48
    cot = torch.randn(2048, 18, device=card, generator=g)
    before = (gather_pyramid_aligned.launches, gather_pyramid_aligned_bwd.launches)
    gather_pyramid_aligned(vol, x, 9, 2, torch.bfloat16).backward(cot.bfloat16())
    assert (gather_pyramid_aligned.launches, gather_pyramid_aligned_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = vol.detach().clone().requires_grad_(True)
    gather_pyramid_aligned_ref(ref, x, 9, 2).backward(cot.bfloat16().float())
    torch.testing.assert_close(vol.grad, ref.grad, rtol=1e-5, atol=1e-5)


# the 9-tap disparity table (4-byte copies), both latent widths (16-byte
# copies), an odd bf16 width (2-byte copies) and B = 1
_TABLES = [(2, 3200, 9, torch.float32), (2, 3200, 184, torch.bfloat16),
           (2, 12800, 40, torch.bfloat16), (1, 77, 7, torch.bfloat16), (3, 64, 33, torch.float32)]


@pytest.mark.parametrize("b,n,c,dtype", _TABLES)
def test_gather_kernel_copies_rows_exactly(card, b, n, c, dtype):
    g = torch.Generator(device=card).manual_seed(2)
    table = torch.randn(b, n, c, device=card, generator=g).to(dtype)
    idx = torch.randint(0, n, (b, 5000), device=card, generator=g, dtype=torch.int32)
    before = gather_rows.launches
    got = gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert got.dtype == dtype and torch.equal(got, gather_rows_ref(table, idx))
    if c > 1:  # a strided view is refused, not copied silently
        with pytest.raises(ValueError):
            gather_rows(table[:, :, : c - 1], idx)


@pytest.mark.parametrize("b,n,c,dtype", _TABLES)
def test_scatter_kernel_sums_duplicates(card, b, n, c, dtype):
    """fp32 atomics: each element's sum is taken in an order that changes from
    run to run, so for each (row, channel)
    |kernel - plain| <= 1e-5 * (1 + sum of |g| over the queries landing there)."""
    g = torch.Generator(device=card).manual_seed(3)
    q = 20 * n if n < 1000 else 51200
    idx = torch.randint(0, n, (b, q), device=card, generator=g, dtype=torch.int32)
    cot = torch.randn(b, q, c, device=card, generator=g).to(dtype)
    before = scatter_rows_add.launches
    got = scatter_rows_add(idx, cot, n)
    want = scatter_rows_add_ref(idx, cot, n)
    bound = 1e-5 * (1.0 + scatter_rows_add_ref(idx, cot.abs(), n))
    torch.cuda.synchronize()
    assert scatter_rows_add.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, n, c)
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("c", [1, 4, 7, 8, 9, 33, 40, 184])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_kernel_vector_widths(card, c, dtype):
    """Every vector width the wrapper picks (4, 2, 1 channels a lane),
    with g's address aligned and offset by one value (which narrows the
    width), B 1 and 3, Q off the rows a warp takes, indices out of range
    (dropped), and every query on one table row (the worst contention):
    |kernel - plain| <= 1e-5 * (1 + sum of |g| landing on the element)."""
    gen = torch.Generator(device=card).manual_seed(5)
    n, q = 300, 5003
    for b in (1, 3):
        idx = torch.randint(0, n, (b, q), device=card, generator=gen, dtype=torch.int32)
        idx[:, :4] = torch.tensor([-1, n, n + 7, -(2 ** 31)], device=card, dtype=torch.int32)
        one_row = torch.full_like(idx, 7)
        buf = torch.randn(b * q * c + 1, device=card, generator=gen).to(dtype)
        for g in (buf[:-1].view(b, q, c), buf[1:].view(b, q, c)):
            for ix in (idx, one_row):
                valid = ((ix >= 0) & (ix < n))[..., None]
                want = scatter_rows_add_ref(ix.clamp(0, n - 1), g * valid, n)
                bound = 1e-5 * (1.0 + scatter_rows_add_ref(ix.clamp(0, n - 1), g.abs() * valid, n))
                before = scatter_rows_add.launches
                got = scatter_rows_add(ix, g, n)
                torch.cuda.synchronize()
                assert scatter_rows_add.launches == before + 1
                assert got.dtype == torch.float32 and got.shape == (b, n, c)
                assert bool(((got - want).abs() <= bound).all()), (b, scatter_vec(c, dtype, g.data_ptr()))


@pytest.mark.parametrize("fn,fwd_launches", [(gather_rows, 1), (gather_rows_hybrid, 0)])
def test_gather_functions_backward_through_the_scatter_kernel(card, fn, fwd_launches):
    g = torch.Generator(device=card).manual_seed(4)
    table = torch.randn(2, 300, 40, device=card, generator=g).bfloat16().requires_grad_(True)
    idx = torch.randint(0, 300, (2, 4000), device=card, generator=g, dtype=torch.int32)
    cot = torch.randn(2, 4000, 40, device=card, generator=g).bfloat16()
    before = (gather_rows.launches, scatter_rows_add.launches)
    fn(table, idx).backward(cot)
    torch.cuda.synchronize()
    assert (gather_rows.launches, scatter_rows_add.launches) == (before[0] + fwd_launches, before[1] + 1)
    assert table.grad.dtype == torch.bfloat16
    want = scatter_rows_add_ref(idx, cot, 300)
    torch.testing.assert_close(table.grad.float(), want, rtol=2.0 ** -7, atol=1e-3)


_CORES = {"igev": lambda **kw: ModelConfig(**kw), "raft": raft_config}


# flavor: (its forward kernel, its backward kernel)
_FLAVOR_KERNELS = {
    "aligned": (gather_pyramid_aligned, gather_pyramid_aligned_bwd),
    "classify": (tw.gather_pyramid_window_pm, tw.gather_pyramid_window_pm_bwd),
    "levels": (tl.gather_window_linear, tl.gather_window_linear_bwd),
}


def _lookup_launches(core, flavor, iters):
    """Forward launches of each flavor's kernel (in `_FLAVOR_KERNELS` order)
    over `iters` iterations under `flavor`: one a volume (IGEV two, RAFT
    one), and for "levels" one a volume and level (IGEV 2 levels, RAFT 4)."""
    n = iters * (2 if core == "igev" else 1)
    if flavor == "levels":
        n *= 2 if core == "igev" else 4
    return [n if f == flavor else 0 for f in _FLAVOR_KERNELS]


def _plain_lookups(monkeypatch_like):
    """Point `ops.lookup` at the plain versions of all three lookup kernels."""
    monkeypatch_like(lookup, "gather_pyramid_aligned", gather_pyramid_aligned_ref)
    monkeypatch_like(lookup, "gather_pyramid_window_pm", tw.gather_pyramid_window_pm_ref)
    monkeypatch_like(lookup, "gather_window_linear", tl.gather_window_linear_ref)


@pytest.mark.parametrize("core", sorted(_CORES))
@pytest.mark.parametrize("flavor", lookup.LOOKUP_KERNELS)
def test_training_forward_backward_through_kernels(card, monkeypatch, core, flavor):
    """A small fp32 training forward and backward of each core under each
    lookup flavor: per iteration one lookup forward and one backward for each
    volume (IGEV two, RAFT one; under "levels" for each level of it too)
    through that flavor's kernels and none through the others'; per decode
    three query gathers forward and three scatter-adds backward; loss and
    gradients agree with the all-plain run."""
    monkeypatch.setenv("ANYSTEREO_LOOKUP_KERNEL", flavor)
    model = build_model(_CORES[core](max_disp=32, compute_dtype="float32"), device=card, seed=0)
    iters = 2
    tcfg = TrainConfig(train_iters=iters)
    g = torch.Generator(device=card).manual_seed(5)
    left = torch.rand(2, 64, 160, 3, device=card, generator=g) * 255
    batch = {"left": left, "right": torch.roll(left, shifts=-4, dims=2),
             "coords": torch.rand(2, 1000, 2, device=card, generator=g) * 2 - 1,
             "scale": torch.tensor([1.5, 2.5], device=card),
             "gt": torch.full((2, 1000), 6.0, device=card), "valid": torch.ones(2, 1000, device=card)}
    kernels = (*(f for f, _ in _FLAVOR_KERNELS.values()), *(b for _, b in _FLAVOR_KERNELS.values()),
               gather_rows, scatter_rows_add)

    def run():
        for p in model.parameters():
            p.grad = None
        loss, _ = loss_and_metrics(model, tcfg, batch)
        loss.backward()
        torch.cuda.synchronize()
        return loss.detach(), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}

    before = [k.launches for k in kernels]
    loss, grads = run()
    want = 2 * _lookup_launches(core, flavor, iters) + [3 * iters, 3 * iters]
    assert [k.launches - b for k, b in zip(kernels, before)] == want
    _plain_lookups(monkeypatch.setattr)
    set_gather_plain(True)
    try:
        before = [k.launches for k in kernels]
        plain_loss, plain_grads = run()
    finally:
        set_gather_plain(False)
    assert [k.launches for k in kernels] == before  # the all-plain run launches nothing
    torch.testing.assert_close(loss, plain_loss, rtol=1e-5, atol=0)
    assert set(grads) == set(plain_grads)
    # absolute part: 1e-7 or, if larger, 1e-8 of the largest gradient norm (a
    # conv bias in front of an instance norm has a true gradient of zero and
    # holds the rounding noise of sums of that size on both sides)
    floor = max(1e-7, 1e-8 * max(float(g.norm()) for g in plain_grads.values()))
    for name, want_g in plain_grads.items():
        assert float((grads[name] - want_g).norm()) <= 1e-3 * float(want_g.norm()) + floor, name


# ------------------------------------------------- the window-pyramid kernels

# name: (function, its backward, plain versions, volume is [L, R], output is [C, R])
_LAYOUTS = {
    "pm": (tw.gather_pyramid_window_pm, tw.gather_pyramid_window_pm_bwd,
           tw.gather_pyramid_window_pm_ref, tw.gather_pyramid_window_pm_bwd_ref, True, False),
    "t": (tw.gather_pyramid_window_t, tw.gather_pyramid_window_t_bwd,
          tw.gather_pyramid_window_t_ref, tw.gather_pyramid_window_t_bwd_ref, True, True),
    "rows": (tw.gather_pyramid_window, tw.gather_pyramid_window_bwd,
             tw.gather_pyramid_window_ref, tw.gather_pyramid_window_bwd_ref, False, False),
}
_FAR = (-1e6, 1e6, -3e9, 3e9, -60.0, 1e4)


def _window_inputs(card, layout, rows, length, levels, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    vol = torch.randn(rows, length, device=card, generator=g)
    bases = torch.stack([torch.rand(rows, device=card, generator=g) * ((length >> lvl) + 16) - 10
                         for lvl in range(levels)], 1)
    bases[: len(_FAR)] = torch.tensor(_FAR, device=card)[:, None]
    cot = torch.randn(rows, levels * 9, device=card, generator=g)
    vol_t, out_t = _LAYOUTS[layout][4:]
    return (vol.t().contiguous() if vol_t else vol, bases.t().contiguous() if vol_t else bases,
            cot.t().contiguous() if out_t else cot)


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
def test_window_kernels_match_plain_versions_exactly(card, layout, levels):
    """Forward and backward repeat the plain versions' operations in their
    order with round-to-nearest intrinsics, so they agree bit for bit; odd
    tails (L 21, 39, 5), far bases (+-1e6, +-3e9) give written zeros."""
    fn, bwd, ref, bwd_ref, vol_t, out_t = _LAYOUTS[layout]
    for rows, length in ((4096, 48), (1000, 312), (777, 39), (300, 21), (33, 5)):
        vol, bases, cot = _window_inputs(card, layout, rows, length, levels)
        before = (fn.launches, bwd.launches)
        got, want = fn(vol, bases, 9), ref(vol, bases, 9)
        dgot, dwant = bwd(bases, cot, length, 9), bwd_ref(bases, cot, length, 9)
        torch.cuda.synchronize()
        assert (fn.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
        assert got.dtype == torch.float32 and got.shape == want.shape and torch.equal(got, want)
        assert dgot.shape == vol.shape and torch.equal(dgot, dwant)
        far_out = got[:, : len(_FAR)] if out_t else got[: len(_FAR)]
        far_grad = dgot[:, : len(_FAR)] if vol_t else dgot[: len(_FAR)]
        assert not far_out.any() and not far_grad.any()
        with pytest.raises(ValueError):  # a strided view is refused, not copied silently
            fn(vol[:, :-1], bases[:, :-1] if vol_t else bases, 9)


def test_window_layouts_agree_on_the_card(card):
    vol, bases, cot = _window_inputs(card, "rows", 5000, 80, 4, seed=1)
    vt, bt = vol.t().contiguous(), bases.t().contiguous()
    rows, pm, tt = tw.gather_pyramid_window(vol, bases, 9), tw.gather_pyramid_window_pm(vt, bt, 9), \
        tw.gather_pyramid_window_t(vt, bt, 9)
    assert torch.equal(rows, pm) and torch.equal(tt.t(), pm)
    d_rows = tw.gather_pyramid_window_bwd(bases, cot, 80, 9)
    d_pm = tw.gather_pyramid_window_pm_bwd(bt, cot, 80, 9)
    d_t = tw.gather_pyramid_window_t_bwd(bt, cot.t().contiguous(), 80, 9)
    assert torch.equal(d_rows.t(), d_pm) and torch.equal(d_t, d_pm)


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_window_lookup_is_differentiable_through_the_kernels(card, layout):
    fn, bwd, ref, _, _, _ = _LAYOUTS[layout]
    vol, bases, cot = _window_inputs(card, layout, 2048, 80, 4, seed=2)
    vol.requires_grad_(True)
    before = (fn.launches, bwd.launches)
    fn(vol, bases, 9).backward(cot)
    assert (fn.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    plain = vol.detach().clone().requires_grad_(True)
    ref(plain, bases, 9).backward(cot)  # PyTorch's own autograd of the plain forward
    torch.testing.assert_close(vol.grad, plain.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("core", sorted(_CORES))
@pytest.mark.parametrize("flavor", lookup.LOOKUP_KERNELS)
def test_eval_forward_counts_and_flavors_agree(card, monkeypatch, core, flavor):
    """A small fp32 eval forward: one lookup launch per volume and iteration
    (and, under "levels", level) through the chosen flavor's kernel only,
    within 1e-3 px of the all-plain forward and of another flavor."""
    model = build_model(_CORES[core](max_disp=32, compute_dtype="float32"), device=card, seed=0)
    g = torch.Generator(device=card).manual_seed(1)
    left = torch.rand(1, 64, 160, 3, device=card, generator=g) * 255
    right = torch.roll(left, shifts=-4, dims=2)
    other = [k for k in lookup.LOOKUP_KERNELS if k != flavor][0]
    monkeypatch.setenv("ANYSTEREO_LOOKUP_KERNEL", other)
    other_out = model(left, right, iters=3)
    monkeypatch.setenv("ANYSTEREO_LOOKUP_KERNEL", flavor)
    forwards = [f for f, _ in _FLAVOR_KERNELS.values()]
    before = [f.launches for f in forwards]
    out = model(left, right, iters=3)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(forwards, before)] == _lookup_launches(core, flavor, 3)
    assert out.disp_final.shape == (1, 64, 160) and torch.isfinite(out.disp_final).all()
    _plain_lookups(monkeypatch.setattr)
    plain = model(left, right, iters=3)
    torch.testing.assert_close(out.disp_final, plain.disp_final, rtol=0, atol=1e-3)
    torch.testing.assert_close(out.disp_final, other_out.disp_final, rtol=0, atol=1e-3)


# ------------------------------------------------- the single-level lookups

_LINEAR_FAR = (-3e9, 3e9, -1e6, 1e6)


@pytest.mark.parametrize("rows,length,taps", [(300, 312, 9), (375, 1242, 1242), (4096, 48, 9),
                                              (777, 39, 9), (50, 78, 2500), (33, 5, 3)])
def test_rows_linear_kernels_match_plain_versions_exactly(card, rows, length, taps):
    """`gather_rows_linear` forward and backward repeat the plain versions'
    operations in their order (the backward adds a row's taps in ascending k,
    no atomics), so they agree bit for bit; far positions give zeros; a row
    whose taps all land on one entry sums them in that order too."""
    g = torch.Generator(device=card).manual_seed(0)
    vol = torch.randn(rows, length, device=card, generator=g)
    pos = torch.rand(rows, taps, device=card, generator=g) * (length + 8) - 4
    pos[0, : min(taps, 4)] = torch.tensor(_LINEAR_FAR, device=card)[: min(taps, 4)]
    pos[1] = 2.25  # every tap of the row collides
    pos[2, 0], pos[2, 1] = -1.0, length - 1.0
    cot = torch.randn(rows, taps, device=card, generator=g)
    before = (tl.gather_rows_linear.launches, tl.gather_rows_linear_bwd.launches)
    got, want = tl.gather_rows_linear(vol, pos), tl.gather_rows_linear_ref(vol, pos)
    dgot, dwant = tl.gather_rows_linear_bwd(pos, cot, length), tl.gather_rows_linear_bwd_ref(pos, cot, length)
    torch.cuda.synchronize()
    assert (tl.gather_rows_linear.launches, tl.gather_rows_linear_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.float32 and got.shape == (rows, taps) and torch.equal(got, want)
    assert dgot.shape == (rows, length) and torch.equal(dgot, dwant)
    assert not got[0, : min(taps, 4)].any()
    with pytest.raises(ValueError):  # a strided view is refused, not copied silently
        tl.gather_rows_linear(vol[:, :-1], pos)


@pytest.mark.parametrize("rows,length", [(239616, 48), (29952, 312), (4096, 24), (777, 39),
                                         (1000, 156), (33, 5)])
def test_window_linear_kernels_match_plain_versions_exactly(card, rows, length):
    g = torch.Generator(device=card).manual_seed(1)
    vol = torch.randn(rows, length, device=card, generator=g)
    base = torch.rand(rows, device=card, generator=g) * (length + 18) - 9
    base[:4] = torch.tensor(_LINEAR_FAR, device=card)
    base[4], base[5] = -1.0, float(length - 9)
    cot = torch.randn(rows, 9, device=card, generator=g)
    before = (tl.gather_window_linear.launches, tl.gather_window_linear_bwd.launches)
    got, want = tl.gather_window_linear(vol, base, 9), tl.gather_window_linear_ref(vol, base, 9)
    dgot = tl.gather_window_linear_bwd(base, cot, length, 9)
    dwant = tl.gather_window_linear_bwd_ref(base, cot, length, 9)
    torch.cuda.synchronize()
    assert (tl.gather_window_linear.launches, tl.gather_window_linear_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert got.shape == (rows, 9) and torch.equal(got, want)
    assert dgot.shape == (rows, length) and torch.equal(dgot, dwant)
    assert not got[:4].any() and not dgot[:4].any()
    # against the arbitrary-position kernel at base + k: the rounding of that sum
    pos = base[:, None] + torch.arange(9, device=card)
    torch.testing.assert_close(got[4:], tl.gather_rows_linear(vol, pos.contiguous())[4:],
                               rtol=1e-5, atol=1e-5)


def test_linear_lookups_are_differentiable_through_the_kernels(card):
    g = torch.Generator(device=card).manual_seed(2)
    vol = torch.randn(2048, 80, device=card, generator=g, requires_grad=True)
    pos = torch.rand(2048, 30, device=card, generator=g) * 88 - 4
    cot = torch.randn(2048, 30, device=card, generator=g)
    kernels = (tl.gather_rows_linear, tl.gather_rows_linear_bwd, tl.gather_window_linear,
               tl.gather_window_linear_bwd)
    before = [k.launches for k in kernels]
    tl.gather_rows_linear(vol, pos).backward(cot)
    tl.gather_window_linear(vol, pos[:, 0].contiguous(), 9).backward(cot[:, :9].contiguous())
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1, 1]
    plain = vol.detach().clone().requires_grad_(True)
    tl.gather_rows_linear_ref(plain, pos).backward(cot)  # PyTorch's own autograd
    tl.gather_window_linear_ref(plain, pos[:, 0], 9).backward(cot[:, :9])
    torch.testing.assert_close(vol.grad, plain.grad, rtol=1e-5, atol=1e-5)


def test_occ_mask_goes_through_the_rows_kernel(card):
    """`gather_1d_linear` on the card: one launch whatever the leading axes,
    and the occlusion mask equals the plain version's."""
    g = torch.Generator(device=card).manual_seed(3)
    dl = torch.rand(2, 375, 1242, device=card, generator=g) * 60
    dr = torch.rand(2, 375, 1242, device=card, generator=g) * 60
    before = tl.gather_rows_linear.launches
    mask = occ_mask(dl, dr)
    assert tl.gather_rows_linear.launches == before + 1
    xs = torch.arange(1242, device=card, dtype=torch.float32)
    plain = (dl - tl.gather_rows_linear_ref(dr, xs - dl)).abs() > 3.0
    assert mask.dtype == torch.bool and torch.equal(mask, plain) and 0 < int(mask.sum()) < mask.numel()
    vol = torch.randn(1, 4, 5, 2, 8, device=card, generator=g)
    pos = torch.rand(1, 4, 5, 2, 7, device=card, generator=g) * 12 - 2
    assert torch.equal(sampling.gather_1d_linear(vol, pos), tl.gather_rows_linear_ref(vol, pos))
