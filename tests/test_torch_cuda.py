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
from anystereo_tpu_torch.train.step import loss_and_metrics, make_eval_step
from anystereo_tpu_torch.utils.profiling import record_spans

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


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_lookup_backward_kernel_tile_edges(card, levels, g_dtype):
    """The edges of the tiled backward (tiles of 64 / 64 / 32 rows as the
    levels deepen): partial last tiles, tiles whose entries are not a
    multiple of 4 (the scalar tail; lengths 5, 45), an offset view of g that
    is only 2- or 4-byte aligned, runs of 8 rows that share x, far positions, the models' 9 taps
    (registers) and 7 (the general walk); equal to the plain version, one
    launch a call."""
    g = torch.Generator(device=card).manual_seed(5)
    for (rows, length), taps in [(case, 9) for case in _TILE_CASES] + [((777, 45), 7), ((1000, 80), 7)]:
        x = torch.rand(rows, device=card, generator=g) * (length + 80) - 40
        x[:4] = torch.tensor([-1e6, 1e6, -3e4, 2.5e3], device=card)
        shared = rows // 16 * 8
        x[rows - shared:] = x[rows - shared:: 8].repeat_interleave(8)
        buf = torch.randn(rows * levels * taps + 1, device=card, generator=g).to(g_dtype)
        for cot in (buf[:-1].view(rows, -1), buf[1:].view(rows, -1)):
            want = gather_pyramid_aligned_bwd_ref(x, cot, length, taps, levels)
            before = gather_pyramid_aligned_bwd.launches
            got = gather_pyramid_aligned_bwd(x, cot, length, taps, levels)
            torch.cuda.synchronize()
            assert gather_pyramid_aligned_bwd.launches == before + 1
            assert got.shape == (rows, length) and torch.equal(got, want)
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


@pytest.mark.parametrize("c,dtype", [(9, torch.float32), (40, torch.bfloat16), (184, torch.bfloat16),
                                     (512, torch.float32), (3, torch.bfloat16)])
def test_gather_kernel_lane_groups(card, c, dtype):
    """The lane groups of the gather: rows of 9 units (3 queries a warp), 5
    (6), 23, 128 (32 lanes looping over the row) and 3 bf16 values; a table
    view off its 16-byte alignment (a narrower unit, more lanes); query
    counts off the 4-query chunks; indices outside [0, n) give zero rows."""
    g = torch.Generator(device=card).manual_seed(6)
    b, n = 3, 257
    buf = torch.randn(b * n * c + 1, device=card, generator=g).to(dtype)
    for table in (buf[:-1].view(b, n, c), buf[1:].view(b, n, c)):
        for q in (1, 5, 4099):
            idx = torch.randint(0, n, (b, q), device=card, generator=g, dtype=torch.int32)
            idx[:, 0] = torch.tensor([-1, n, 2 ** 31 - 1][:b], dtype=torch.int32, device=card)
            before = gather_rows.launches
            got = gather_rows(table, idx)
            torch.cuda.synchronize()
            assert gather_rows.launches == before + 1
            assert not got[:, 0].any()
            assert torch.equal(got[:, 1:], gather_rows_ref(table, idx[:, 1:].contiguous()))


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


@pytest.mark.parametrize("c", [1, 4, 9, 40, 184])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_kernel_deterministic_mode(card, c, dtype):
    """Under `torch.use_deterministic_algorithms(True)` the wrapper launches
    the ordered kernel once a call: a second call gives the same bits, and
    both equal the plain version bit for bit, each row summed in ascending
    q; indices out of range are dropped and rows no query reaches are zero.
    Also with g's address offset by one value (a narrower vector), batches
    of 1 and 3, n not a multiple of a block's rows, half of the queries on
    one row, segments of the indices with more queries on a block's rows
    than a warp stages, and every query on one row (more than a block's
    list holds: its windows).  The plain version runs on
    the CPU, whose `index_add_` adds in ascending q: PyTorch's deterministic
    `index_add_` on the card sums 32 or more queries of a one-channel row
    across a warp's lanes, in an order of its own."""
    gen = torch.Generator(device=card).manual_seed(6)
    n, q = 300, 5003
    idx = torch.randint(0, n - 20, (2, q), device=card, generator=gen, dtype=torch.int32)
    idx[:, :4] = torch.tensor([-1, n, n + 7, -(2 ** 31)], device=card, dtype=torch.int32)
    buf = torch.randn(3 * 20000 * c + 1, device=card, generator=gen).to(dtype)
    # 40 rows, blocks of 8: the first half of the queries, 4,096, on the
    # first block's rows, its first segments' 512 queries all on them
    crowded = torch.randint(8, 40, (1, 8192), device=card, generator=gen, dtype=torch.int32)
    crowded[:, :4096] = torch.arange(4096, device=card, dtype=torch.int32) % 8
    half = torch.randint(0, n, (3, q), device=card, generator=gen, dtype=torch.int32)
    half[:, ::2] = 5
    cases = [(idx, buf[:2 * q * c].view(2, q, c), n), (idx[:1].contiguous(), buf[1:q * c + 1].view(1, q, c), n),
             (half, buf[:3 * q * c].view(3, q, c), n), (crowded, buf[:8192 * c].view(1, 8192, c), 40),
             (torch.full((1, 20000), 7, device=card, dtype=torch.int32), buf[:20000 * c].view(1, 20000, c), n)]
    results = []
    for ix, g, rows in cases:
        valid = ((ix >= 0) & (ix < rows))[..., None]
        torch.use_deterministic_algorithms(True)
        try:
            want = scatter_rows_add_ref(ix.clamp(0, rows - 1).cpu(), (g * valid).cpu(), rows)
            before = scatter_rows_add.launches
            got, again = scatter_rows_add(ix, g, rows), scatter_rows_add(ix, g, rows)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        assert scatter_rows_add.launches == before + 2
        assert got.dtype == torch.float32 and got.shape == (ix.shape[0], rows, c)
        assert torch.equal(got, again)
        assert torch.equal(got.cpu(), want), (tuple(ix.shape), scatter_vec(c, dtype, g.data_ptr()),
                                              float((got.cpu() - want).abs().max()))
        results.append(got)
    assert not results[0][:, n - 20:].any() and not results[4][:, torch.arange(n, device=card) != 7].any()


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


def test_remat_training_step_through_kernels(card, monkeypatch):
    """A small fp32 IGEV training forward and backward with
    `ModelConfig(remat=True)` against the same without, both through the
    kernels under "aligned": the backward runs each iteration's body again,
    so per iteration the lookup forward launches twice a volume and the
    query gather six times (three tables, twice), while the lookup backward
    and the scatter-add launch as without; loss and gradients agree."""
    monkeypatch.setenv("ANYSTEREO_LOOKUP_KERNEL", "aligned")
    iters = 2
    tcfg = TrainConfig(train_iters=iters)
    g = torch.Generator(device=card).manual_seed(5)
    left = torch.rand(2, 64, 160, 3, device=card, generator=g) * 255
    batch = {"left": left, "right": torch.roll(left, shifts=-4, dims=2),
             "coords": torch.rand(2, 1000, 2, device=card, generator=g) * 2 - 1,
             "scale": torch.tensor([1.5, 2.5], device=card),
             "gt": torch.full((2, 1000), 6.0, device=card), "valid": torch.ones(2, 1000, device=card)}
    kernels = (gather_pyramid_aligned, gather_pyramid_aligned_bwd, gather_rows, scatter_rows_add)
    runs = {}
    for remat in (False, True):
        model = build_model(ModelConfig(max_disp=32, compute_dtype="float32", remat=remat), device=card,
                            seed=0)
        before = [k.launches for k in kernels]
        loss, _ = loss_and_metrics(model, tcfg, batch)
        loss.backward()
        torch.cuda.synchronize()
        runs_of_body = 2 if remat else 1
        assert [k.launches - b for k, b in zip(kernels, before)] == \
            [runs_of_body * 2 * iters, 2 * iters, runs_of_body * 3 * iters, 3 * iters]
        runs[remat] = loss.detach(), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    (loss, grads), (remat_loss, remat_grads) = runs[False], runs[True]
    torch.testing.assert_close(remat_loss, loss, rtol=1e-5, atol=0)
    assert set(grads) == set(remat_grads)
    floor = max(1e-7, 1e-8 * max(float(g.norm()) for g in grads.values()))
    for name, want_g in grads.items():
        assert float((remat_grads[name] - want_g).norm()) <= 1e-3 * float(want_g.norm()) + floor, name


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


def _smooth_positions(card, rows, length, groups):
    """Positions shaped as the main path gives them: a smooth disparity
    field d (4 to 40) over image rows of w cells; `groups` > 1 gives x = d
    for each run of `groups` rows (the GEV volume, w = 80), 1 gives
    x = column - d (the correlation, w = L).  `rows` need not be a whole
    number of cells."""
    w = 80 if groups > 1 else length
    cells = -(-rows // groups)
    col = torch.arange(cells, device=card, dtype=torch.float32) % w
    row = torch.arange(cells, device=card, dtype=torch.float32) // w
    d = 22 + 18 * torch.sin(6.283 * (1.5 * col / w + 0.05 * row)) * torch.cos(0.1 * row)
    x = d.repeat_interleave(groups) if groups > 1 else col - d
    return x[:rows].contiguous()


def _pm_bases(card, x, levels, far=True):
    """[levels, R] window starts x * 2^-lvl - 4, as the classify flavor
    forms them; with `far`, the first rows at +-1e6 and +-3e9."""
    scales = torch.tensor([2.0 ** -lvl for lvl in range(levels)], device=card)
    bases = x[None, :] * scales[:, None] - 4
    if far:
        bases[:, : len(_FAR)] = torch.tensor(_FAR, device=card)[None, :]
    return bases.contiguous()


def _pm_all_layouts(vol_t, bases_t, taps):
    """The pixel-major kernel's output, checked bit for bit against its plain
    version and against the two other layouts' kernels on the same operands."""
    got = tw.gather_pyramid_window_pm(vol_t, bases_t, taps)
    want = tw.gather_pyramid_window_pm_ref(vol_t, bases_t, taps)
    t_out = tw.gather_pyramid_window_t(vol_t, bases_t, taps)
    rows_out = tw.gather_pyramid_window(vol_t.t().contiguous(), bases_t.t().contiguous(), taps)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want)
    assert torch.equal(t_out.t(), got) and torch.equal(rows_out, got)
    return got


# (rows, length, levels): tiles of 32 rows with a ragged last one and R % 4
# != 0 (scalar copies), R % 4 == 0 (16-byte copies), the eval GEV and corr
# shapes and the RAFT one, and rows shorter than a cell at 3-5 levels
_PM_CASES = [(205, 48, 2), (777, 312, 2), (4096, 80, 4), (239616 + 5, 48, 2), (239616, 48, 2),
             (29952, 312, 2), (29952, 312, 4), (333, 5, 3), (333, 5, 4), (333, 5, 5), (257, 7, 5)]


@pytest.mark.parametrize("rows,length,levels", _PM_CASES)
@pytest.mark.parametrize("positions", ["random", "path", "apart", "gap"])
def test_window_pm_forward_tiles_and_spans(card, rows, length, levels, positions):
    """The redesigned pixel-major forward (tiles of 32 rows, the span staged
    in chunks of up to 128 entries) equals its plain version and the other two
    layouts bit for bit: random positions over the row and 20 past its ends
    (a tile's span is the whole row, several chunks at L 312), path-shaped
    ones (a span of about one window), each level its own start away from
    the row's start (a span that starts at an odd entry, deeper cells at the
    end of a chunk), half of each tile near the row's start and half far
    along (a stretch no row needs, skipped), far bases, ragged tiles."""
    g = torch.Generator(device=card).manual_seed(rows + length + levels)
    vol_t = torch.randn(length, rows, device=card, generator=g)
    if positions == "random":
        x = torch.rand(rows, device=card, generator=g) * (length + 40) - 20
    else:
        x = _smooth_positions(card, rows, length, 8 if length == 48 else 1)
    bases = _pm_bases(card, x, levels)
    if positions == "apart":
        for lvl in range(levels):
            n = length >> lvl
            bases[lvl, len(_FAR):] = torch.rand(rows - len(_FAR), device=card, generator=g) * max(n - 15, 1) + 3
    if positions == "gap":  # half of each tile near the row's start, half far along: the
        # walk skips the stretch between; at L 312 and 2 levels the far half needs
        # [151, 161) and [278, 298), so a chunk from 151 would end inside the
        # level-1 cell [278, 280): it starts at 150
        low = (torch.arange(rows, device=card) % 32) < 16
        far = [151.5, 139.25] if (length, levels) == (312, 2) else \
            [0.45 * (length >> lvl) + 0.25 for lvl in range(levels)]
        for lvl in range(levels):
            bases[lvl, len(_FAR):] = torch.where(low, 1.25, far[lvl])[len(_FAR):]
    before = tw.gather_pyramid_window_pm.launches
    got = _pm_all_layouts(vol_t, bases, 9)
    assert tw.gather_pyramid_window_pm.launches == before + 1
    assert not got[: len(_FAR)].any()


@pytest.mark.parametrize("taps,levels", [(1, 2), (5, 4), (17, 2), (80, 5), (346, 5)])
def test_window_pm_forward_other_taps(card, taps, levels):
    """Taps other than 9: the tap stage grows with levels*taps (past 48 KB
    the launch asks for more shared memory; on rows of 80 entries 346 taps
    at 5 levels is the most a block holds); 347 taps at 5 levels is
    refused."""
    g = torch.Generator(device=card).manual_seed(taps)
    vol_t = torch.randn(80, 1001, device=card, generator=g)
    x = torch.rand(1001, device=card, generator=g) * 120 - 20
    _pm_all_layouts(vol_t, _pm_bases(card, x, levels), taps)
    if taps == 346:
        with pytest.raises(RuntimeError):
            tw.gather_pyramid_window_pm(vol_t, _pm_bases(card, x, levels), taps + 1)


def test_window_pm_forward_unaligned_volume(card):
    """A volume that starts 4 bytes past a 16-byte boundary takes the 4-byte
    copies even where R % 4 == 0."""
    g = torch.Generator(device=card).manual_seed(5)
    flat = torch.randn(1 + 312 * 1024, device=card, generator=g)
    vol_t = flat[1:].view(312, 1024)
    assert vol_t.is_contiguous() and vol_t.data_ptr() % 16 == 4
    x = torch.rand(1024, device=card, generator=g) * 352 - 20
    _pm_all_layouts(vol_t, _pm_bases(card, x, 4), 9)


# (rows, length, levels): the [L, R] backward's tiles of 32 rows, with L split
# over grid.y while the tiles give a card of 132 SMs fewer than 4 blocks an
# SM (the RAFT training shape: 3 ranges of 32 entries), L whole at the eval
# shapes; ragged tiles and R % 4 != 0, L % 4 != 0 and L not a multiple of a
# range, L 1 and 2, levels up to 5
_TB_CASES = [(6400, 80, 4), (6400 + 7, 80, 2), (29952, 312, 4), (239616, 48, 2), (239616 + 3, 48, 2),
             (200, 79, 4), (1001, 39, 3), (33, 1, 1), (70, 2, 2), (70, 2, 5), (5000, 21, 5), (1, 313, 5)]


def _t_backwards(card, bases_t, cot, length, taps, offset=0):
    """Both [L, R] backwards (layouts 0 and 1) on one cotangent [R, C], held
    to their plain versions bit for bit with one launch each; the cotangent
    placed `offset` floats past a 16-byte boundary.  Returns layout 0's."""
    outs = []
    for bwd, ref, g in ((tw.gather_pyramid_window_pm_bwd, tw.gather_pyramid_window_pm_bwd_ref, cot),
                        (tw.gather_pyramid_window_t_bwd, tw.gather_pyramid_window_t_bwd_ref, cot.t())):
        flat = torch.empty(offset + g.numel(), device=card)
        g = flat[offset:].view(g.shape).copy_(g)
        assert g.is_contiguous() and g.data_ptr() % 16 == 4 * offset
        before = bwd.launches
        got, want = bwd(bases_t, g, length, taps), ref(bases_t, g, length, taps)
        torch.cuda.synchronize()
        assert bwd.launches == before + 1
        assert got.shape == (length, bases_t.shape[1]) and torch.equal(got, want)
        outs.append(got)
    assert torch.equal(outs[0], outs[1])
    return outs[0]


@pytest.mark.parametrize("rows,length,levels", _TB_CASES)
@pytest.mark.parametrize("positions", ["random", "path"])
def test_window_t_backward_tiles(card, rows, length, levels, positions):
    """The redesigned [L, R] backward (a block a tile of 32 rows and a range
    of L, the cotangent staged once, slot coefficients formed once, chunks
    of entries walked by cell, zeros outside the tile's hulls) equals its
    plain version bit for bit in both layouts, at random and path-shaped
    bases, far bases as zero columns, on an aligned cotangent and on one 4
    bytes past a 16-byte boundary."""
    g = torch.Generator(device=card).manual_seed(rows + length + levels)
    if positions == "random":
        x = torch.rand(rows, device=card, generator=g) * (length + 40) - 20
    else:
        x = _smooth_positions(card, rows, length, 8 if length == 48 else 1)
    far = rows >= len(_FAR)
    bases = _pm_bases(card, x, levels, far=far)
    cot = torch.randn(rows, levels * 9, device=card, generator=g)
    for offset in (0, 1):
        got = _t_backwards(card, bases, cot, length, 9, offset)
        if far:
            assert not got[:, : len(_FAR)].any()


@pytest.mark.parametrize("taps,levels", [(1, 2), (17, 4), (176, 5), (177, 5), (400, 3)])
def test_window_t_backward_other_taps(card, taps, levels):
    """Taps other than 9: the coefficient table grows with levels*taps (past
    48 KB the launch asks for more shared memory; 176 taps at 5 levels is the
    most a block holds), and wider windows take the walk of a thread a row;
    both bit for bit the plain versions."""
    g = torch.Generator(device=card).manual_seed(taps + levels)
    x = torch.rand(3001, device=card, generator=g) * 170 - 20
    bases = _pm_bases(card, x, levels)
    cot = torch.randn(3001, levels * taps, device=card, generator=g)
    _t_backwards(card, bases, cot, 130, taps)


def test_window_t_forward_takes_windows_wider_than_the_pm_stage(card):
    """B5's forward stores each tap as it forms it, so it keeps no tap stage
    and takes 347 taps at 5 levels, one more than B4's forward holds."""
    g = torch.Generator(device=card).manual_seed(347)
    vol_t = torch.randn(80, 1001, device=card, generator=g)
    bases = _pm_bases(card, torch.rand(1001, device=card, generator=g) * 120 - 20, 5)
    before = tw.gather_pyramid_window_t.launches
    got = tw.gather_pyramid_window_t(vol_t, bases, 347)
    want = tw.gather_pyramid_window_t_ref(vol_t, bases, 347)
    torch.cuda.synchronize()
    assert tw.gather_pyramid_window_t.launches == before + 1
    assert got.shape == want.shape and torch.equal(got, want) and not got[:, :4].any()  # +-1e6, +-3e9


# (rows, length, levels): the [R, L] backward's tiles on a card of 132 SMs:
# 32 rows from 33,761 rows on (1,056 tiles, 8 an SM), 16 from 16,881, 8
# below; the eval GEV and corr shapes and the RAFT one; ragged tiles, L % 4
# != 0 (rows off the 16-byte grid), L 1, 2 and 5 at up to 5 levels
_RB_CASES = [(239616, 48, 2), (239616 + 3, 48, 2), (29952, 312, 2), (29952, 312, 4),
             (33761, 48, 2), (33760, 48, 2), (16881, 80, 3), (16880, 80, 3), (6400, 80, 4),
             (1001, 39, 3), (777, 41, 5), (33, 1, 1), (70, 2, 2), (70, 5, 5), (1, 313, 5)]


def _rows_backward(card, bases, cot, length, taps, offset=0):
    """The [R, L] backward on a cotangent placed `offset` floats past a
    16-byte boundary, held to its plain version bit for bit with one
    launch."""
    flat = torch.empty(offset + cot.numel(), device=card)
    g = flat[offset:].view(cot.shape).copy_(cot)
    assert g.is_contiguous() and g.data_ptr() % 16 == 4 * offset
    before = tw.gather_pyramid_window_bwd.launches
    got = tw.gather_pyramid_window_bwd(bases, g, length, taps)
    want = tw.gather_pyramid_window_bwd_ref(bases, g, length, taps)
    torch.cuda.synchronize()
    assert tw.gather_pyramid_window_bwd.launches == before + 1
    assert got.shape == (bases.shape[0], length) and torch.equal(got, want)
    return got


@pytest.mark.parametrize("rows,length,levels", _RB_CASES)
@pytest.mark.parametrize("positions", ["random", "path"])
def test_window_rows_backward_tiles(card, rows, length, levels, positions):
    """The redesigned [R, L] backward (a block a tile of rows, the cotangent
    and bases staged once, slot coefficients formed once, the tile's dvol
    walked as 16-byte vectors) equals its plain version bit for bit at
    random and path-shaped bases, far bases as zero rows, on an aligned
    cotangent and on one 4 bytes past a 16-byte boundary."""
    g = torch.Generator(device=card).manual_seed(rows + length + levels)
    if positions == "random":
        x = torch.rand(rows, device=card, generator=g) * (length + 40) - 20
    else:
        x = _smooth_positions(card, rows, length, 8 if length == 48 else 1)
    far = rows >= len(_FAR)
    bases = _pm_bases(card, x, levels, far=far).t().contiguous()
    cot = torch.randn(rows, levels * 9, device=card, generator=g)
    for offset in (0, 1):
        got = _rows_backward(card, bases, cot, length, 9, offset)
        if far:
            assert not got[: len(_FAR)].any()


@pytest.mark.parametrize("taps,levels", [(1, 2), (17, 4), (400, 5), (1000, 5), (3000, 1)])
def test_window_rows_backward_other_taps(card, taps, levels):
    """Taps other than 9: the tile's shared memory grows with levels*taps
    (past 48 KB the launch asks for more; 3,000 taps at one level still
    fit a tile of 8 rows), and a tile too large for a block (1,000 taps at 5
    levels) takes the walk of a warp a row; both bit for bit the plain
    version."""
    g = torch.Generator(device=card).manual_seed(taps + levels)
    x = torch.rand(3001, device=card, generator=g) * 170 - 20
    bases = _pm_bases(card, x, levels).t().contiguous()
    cot = torch.randn(3001, levels * taps, device=card, generator=g)
    _rows_backward(card, bases, cot, 130, taps)


# (rows, length, levels): the [R, L] forward's tiles on a card of 132 SMs:
# 64 rows from 67,521 rows on, 32 from 33,761, 16 from 16,881, 8 below; the
# eval GEV and corr shapes, the RAFT one and the spatial tile's correlation
# (rows of 504 entries); ragged tiles, L % 4 != 0 (4-byte copies), L 1, 2
# and 5 at up to 5 levels, rows of 8,000 entries
_RF_CASES = [(239616, 48, 2), (239616 + 3, 48, 2), (29952, 312, 2), (29952, 312, 4),
             (67521, 48, 2), (67520, 48, 2), (96768, 504, 2), (16881, 80, 3), (6400, 80, 4),
             (1001, 39, 3), (777, 45, 5), (33, 1, 1), (70, 2, 2), (70, 5, 5), (1, 313, 5),
             (3001, 8000, 2)]


def _rows_forward(card, vol, bases, taps, offset=0):
    """The [R, L] forward on a volume placed `offset` floats past a 16-byte
    boundary, held to its plain version bit for bit with one launch."""
    flat = torch.empty(offset + vol.numel(), device=card)
    v = flat[offset:].view(vol.shape).copy_(vol)
    assert v.is_contiguous() and v.data_ptr() % 16 == 4 * offset
    before = tw.gather_pyramid_window.launches
    got, want = tw.gather_pyramid_window(v, bases, taps), tw.gather_pyramid_window_ref(v, bases, taps)
    torch.cuda.synchronize()
    assert tw.gather_pyramid_window.launches == before + 1
    assert got.shape == (vol.shape[0], bases.shape[1] * taps) and torch.equal(got, want)
    return got


@pytest.mark.parametrize("rows,length,levels", _RF_CASES)
@pytest.mark.parametrize("positions", ["random", "path", "apart"])
def test_window_rows_forward_tiles(card, rows, length, levels, positions):
    """The redesigned [R, L] forward (a block a tile of rows, each row's hull
    staged once by cp.async into a slot of the row, the taps formed from
    shared memory and stored as 16-byte vectors) equals its plain version
    and the pixel-major kernel bit for bit at random and path-shaped bases
    and with each level's window apart from the others (hulls wider than a
    slot, read from device memory), far bases as zero rows, on an aligned
    volume (16-byte copies where L % 4 == 0) and on one 4 bytes past a
    16-byte boundary (4-byte copies)."""
    g = torch.Generator(device=card).manual_seed(rows + length + levels)
    vol = torch.randn(rows, length, device=card, generator=g)
    if positions == "path":
        x = _smooth_positions(card, rows, length, 8 if length == 48 else 1)
    else:
        x = torch.rand(rows, device=card, generator=g) * (length + 40) - 20
    far = rows >= len(_FAR)
    bases_t = _pm_bases(card, x, levels, far=far)
    if positions == "apart":
        for lvl in range(levels):
            n = length >> lvl
            bases_t[lvl, len(_FAR):] = torch.rand(max(rows - len(_FAR), 0), device=card,
                                                  generator=g) * max(n - 15, 1) + 3
    bases = bases_t.t().contiguous()
    for offset in (0, 1):
        got = _rows_forward(card, vol, bases, 9, offset)
        if far:
            assert not got[: len(_FAR)].any()
    assert torch.equal(got, tw.gather_pyramid_window_pm(vol.t().contiguous(), bases_t, 9))


@pytest.mark.parametrize("taps,levels", [(1, 2), (17, 4), (100, 5), (3000, 1)])
def test_window_rows_forward_other_taps(card, taps, levels):
    """Taps other than 9: the slots and the tap stage grow with the window
    (past 48 KB the launch asks for more shared memory: 3,000 taps at one
    level still fit a tile of 8 rows); bit for bit the plain version."""
    g = torch.Generator(device=card).manual_seed(taps + levels)
    vol = torch.randn(3001, 130, device=card, generator=g)
    x = torch.rand(3001, device=card, generator=g) * 170 - 20
    bases = _pm_bases(card, x, levels).t().contiguous()
    _rows_forward(card, vol, bases, taps)


@pytest.mark.parametrize("rows,length,levels,taps", [(501, 130, 1, 7300), (300, 130, 5, 400)])
def test_window_rows_forward_walk(card, rows, length, levels, taps):
    """A tile of 8 rows that does not fit a block (7,300 taps at one level,
    400 at five) takes the walk of a thread a (row, level): bit for bit the
    plain version, one launch."""
    g = torch.Generator(device=card).manual_seed(length + taps)
    vol = torch.randn(rows, length, device=card, generator=g)
    x = torch.rand(rows, device=card, generator=g) * (length + 40) - 20
    bases = _pm_bases(card, x, levels).t().contiguous()
    got = _rows_forward(card, vol, bases, taps)
    assert not got[:4].any()  # +-1e6, +-3e9


# (rows, length): the eval GEV shapes (tiles of 32 rows a warp), the
# training GEV's (16 rows), the eval and training correlation's (a thread a
# tap), ragged last tiles and blocks, and the edges of the tile heights on a
# card of 132 SMs (67,553 rows the fewest for 32-row tiles, 33,777 for 16)
_WL_CASES = [(239616, 48), (239616 + 3, 24), (51200 + 17, 48), (29952, 312), (29952, 39),
             (6400, 80), (6401, 40), (100, 5), (1, 1242),
             (67553, 48), (67552, 48), (33777, 24), (33776, 24)]


@pytest.mark.parametrize("rows,length", _WL_CASES)
@pytest.mark.parametrize("positions", ["random", "path"])
def test_window_linear_forward_tiles(card, rows, length, positions):
    """The redesigned window forward (one window a row staged once, taps
    stored four at a time; a thread a tap at a few thousand rows) equals its
    plain version bit for bit at random and path-shaped starts, far starts
    included, whatever the tile height."""
    g = torch.Generator(device=card).manual_seed(rows + length)
    vol = torch.randn(rows, length, device=card, generator=g)
    if positions == "random":
        base = torch.rand(rows, device=card, generator=g) * (length + 18) - 9
    else:
        base = _smooth_positions(card, rows, length, 8 if length in (48, 24) else 1) - 4
    base[: min(rows, 4)] = torch.tensor(_LINEAR_FAR, device=card)[: min(rows, 4)]
    before = tl.gather_window_linear.launches
    got, want = tl.gather_window_linear(vol, base, 9), tl.gather_window_linear_ref(vol, base, 9)
    torch.cuda.synchronize()
    assert tl.gather_window_linear.launches == before + 1
    assert got.shape == (rows, 9) and torch.equal(got, want)
    assert not got[: min(rows, 4)].any()


@pytest.mark.parametrize("rows", [3001, 70001])
@pytest.mark.parametrize("taps", [1, 2, 5, 17, 93, 94, 300])
def test_window_linear_forward_other_taps(card, rows, taps):
    """Taps other than 9 take the kernels with a runtime count: at 70,001
    rows the warp tiles, with windows up to 94 entries (93 taps) through
    shared memory, and a thread a tap for wider windows and at 3,001 rows;
    all bit for bit the plain version, on a volume that starts off a
    16-byte boundary."""
    g = torch.Generator(device=card).manual_seed(taps)
    flat = torch.randn(1 + rows * 130, device=card, generator=g)
    vol = flat[1:].view(rows, 130)
    base = torch.rand(rows, device=card, generator=g) * 160 - 20 - taps / 2
    base[:4] = torch.tensor(_LINEAR_FAR, device=card)
    got, want = tl.gather_window_linear(vol, base, taps), tl.gather_window_linear_ref(vol, base, taps)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and not got[:4].any()


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


@pytest.mark.parametrize("core", sorted(_CORES))
def test_spans_time_each_stage_on_the_trace_clock(card, monkeypatch, core):
    """Spans over a small bf16 eval step under a device-only profiler: every
    stage has stream time, the stages lie within the step's, B1 launches in
    the `gru` spans alone (one a volume and iteration), and each boundary's
    own cudaEventRecord call starts within 50 us of the host stamps around
    it on the trace's clock."""
    monkeypatch.setenv("ANYSTEREO_LOOKUP_KERNEL", "aligned")
    step = make_eval_step(build_model(_CORES[core](max_disp=32), device=card, seed=0), valid_iters=3,
                          device=card)
    g = torch.Generator(device=card).manual_seed(1)
    left = torch.rand(2, 64, 160, 3, device=card, generator=g) * 255
    args = (left, torch.roll(left, shifts=-4, dims=2), None, torch.ones(2, device=card))
    step(*args).cpu()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with record_spans() as rec:
            step(*args).cpu()
    records = rec.collect(prof)
    assert [r["name"] for r in records] == ["eval_step", "matching", "cost", "context"] + ["gru"] * 3 + ["decode"]
    per_iter = _lookup_launches(core, "aligned", 1)[0]
    for r in records[1:]:
        assert r["stream_ms"] > 0 and r["parent"] == records[0]["id"]
        assert r["launches"] == ({"B1 fwd": per_iter} if r["name"] == "gru" else {}), r["name"]
    assert sum(r["stream_ms"] for r in records[1:]) <= records[0]["stream_ms"]
    gaps = [max(0.0, a - x, x - b) for r in records for x, a, b in zip(r["anchor_us"], r["trace_us"], r["record_us"])]
    assert max(gaps) < 50.0, gaps


@pytest.mark.parametrize("core", sorted(_CORES))
def test_no_layout_transposes_in_the_gru_loop(card, monkeypatch, core):
    """A bf16 eval step with cuDNN's default choices, under a device-only
    profiler, each device activity put in the span whose launch call started
    it: every activity has its call, the `gru` spans launch kernels, and none
    of theirs is one of cuDNN's layout transposes (`nchwToNhwc`,
    `nhwcToNchw`), since the update block's maps and weights are
    channels-last."""
    from stereo_bench.layout_trace import NO_CALL, launched_in, transposes_by_span

    monkeypatch.setenv("ANYSTEREO_LOOKUP_KERNEL", "aligned")
    step = make_eval_step(build_model(_CORES[core](max_disp=64), device=card, seed=0), valid_iters=3,
                          device=card)
    g = torch.Generator(device=card).manual_seed(1)
    left = torch.rand(2, 128, 320, 3, device=card, generator=g) * 255
    args = (left, torch.roll(left, shifts=-4, dims=2), None, torch.ones(2, device=card))
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False):
        step(*args).cpu()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            with record_spans() as rec:
                step(*args).cpu()
    ops = launched_in(rec.collect(prof), prof)
    assert ops and [name for owner, name, _ in ops if owner == NO_CALL] == []
    assert sum(owner == "gru" for owner, _, _ in ops) >= 3 * 100
    assert "gru" not in transposes_by_span(ops), transposes_by_span(ops)


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


def _warp_positions(card, rows, length, taps, g):
    """x - disparity over `taps` columns spread across the row, as the
    occlusion warp forms it: not monotone where the disparity jumps."""
    x = torch.arange(taps, device=card, dtype=torch.float32) * (length / taps)
    return (x - torch.rand(rows, taps, device=card, generator=g) * 60).contiguous()


@pytest.mark.parametrize("rows,length,taps,positions", [
    (3, 5000, 700, "random"),     # a row longer than one block's range: 8 ranges of 625
    (7, 5000, 9000, "warp"),      # and K over several chunks of 1,280
    (40, 300, 4000, "random"),    # K over several chunks, K > L
    (1, 1242, 1242, "warp"),      # a single row
    (375, 1242, 1242, "warp"),    # the occlusion warp's shape
    (300, 312, 9, "random"),      # a row of 32 taps or fewer is walked, not sorted
    (50, 700, 33, "random"),      # two groups, each its own warp
    (64, 1281, 1300, "random"),   # a chunk of 1,280, then one of 20
    (5, 1, 40, "random"),
])
def test_rows_linear_backward_sort_edges(card, rows, length, taps, positions):
    """The redesigned rows backward (a stable bucket sort of each row's taps
    by entry, then a merge by k) equals its plain version bit for bit with
    one launch, at ranges that split a row, chunks that carry the sum, a
    single row and non-monotone warp positions; as the gradient of
    `gather_rows_linear` too."""
    g = torch.Generator(device=card).manual_seed(rows + length + taps)
    if positions == "warp":
        pos = _warp_positions(card, rows, length, taps, g)
    else:
        pos = torch.rand(rows, taps, device=card, generator=g) * (length + 8) - 4
    pos[0, : min(taps, 4)] = torch.tensor(_LINEAR_FAR, device=card)[: min(taps, 4)]
    if rows > 1:
        pos[1] = 2.25  # every tap of the row on one entry
    cot = torch.randn(rows, taps, device=card, generator=g)
    before = tl.gather_rows_linear_bwd.launches
    dgot = tl.gather_rows_linear_bwd(pos, cot, length)
    dwant = tl.gather_rows_linear_bwd_ref(pos, cot, length)
    torch.cuda.synchronize()
    assert tl.gather_rows_linear_bwd.launches == before + 1
    assert dgot.shape == (rows, length) and torch.equal(dgot, dwant)
    vol = torch.randn(rows, length, device=card, generator=g, requires_grad=True)
    tl.gather_rows_linear(vol, pos).backward(cot)
    assert tl.gather_rows_linear_bwd.launches == before + 2 and torch.equal(vol.grad, dwant)


# the window backward's tiles: 32 rows from 67,553 rows on a card of 132 SMs,
# 16 from 33,777, 8 from 16,889, else 4; ragged last tiles and fewer rows
# than one tile; L % 4 != 0
_WLB_CASES = [(239616, 48, 9), (239616 + 3, 24, 9), (51200, 48, 9), (51200 + 17, 24, 9),
              (29952, 312, 9), (29952 + 1, 156, 9), (29953, 39, 9), (6400, 80, 9), (6401, 40, 9),
              (67553, 48, 9), (67552, 48, 9), (33777, 24, 9), (16889, 78, 9), (16888, 78, 9),
              (3, 48, 9), (1, 1242, 9), (100, 5, 9), (70, 3, 9),
              (3001, 130, 1), (70001, 130, 5), (3001, 130, 17), (70001, 39, 17), (3001, 130, 93),
              (2000, 900, 766), (2000, 900, 767), (50, 300, 2000)]


@pytest.mark.parametrize("rows,length,taps", _WLB_CASES)
def test_window_linear_backward_tiles(card, rows, length, taps):
    """The redesigned window backward (a warp a tile of rows, coefficients
    formed once, dvol stored four entries at a time; a warp a row for windows
    wider than 767 entries) equals its plain version bit for bit with one
    launch, far starts included; as the gradient of `gather_window_linear`
    too."""
    g = torch.Generator(device=card).manual_seed(rows + length + taps)
    base = torch.rand(rows, device=card, generator=g) * (length + taps + 9) - taps - 4
    base[: min(rows, 4)] = torch.tensor(_LINEAR_FAR, device=card)[: min(rows, 4)]
    cot = torch.randn(rows, taps, device=card, generator=g)
    before = tl.gather_window_linear_bwd.launches
    dgot = tl.gather_window_linear_bwd(base, cot, length, taps)
    dwant = tl.gather_window_linear_bwd_ref(base, cot, length, taps)
    torch.cuda.synchronize()
    assert tl.gather_window_linear_bwd.launches == before + 1
    assert dgot.shape == (rows, length) and torch.equal(dgot, dwant)
    assert not dgot[: min(rows, 4)].any()
    vol = torch.randn(rows, length, device=card, generator=g, requires_grad=True)
    tl.gather_window_linear(vol, base, taps).backward(cot)
    assert tl.gather_window_linear_bwd.launches == before + 2 and torch.equal(vol.grad, dwant)


# (rows, length, taps, offset): the staged rows forward (a block a row and a
# range of up to 2,048 taps, the row copied into shared memory) at the
# occlusion warp's shape and one row of it, L % 4 != 0 (rows off a 16-byte
# boundary), K != L and K over 2,048, volume and positions `offset` floats
# past a 16-byte boundary (positions and output then at different offsets:
# scalar taps); the longest staged row and the first too long, and K < L/4,
# which take a thread a tap
_RF_CASES = [(375, 1242, 1242, 0), (1, 1242, 1242, 0), (375, 1241, 1242, 1), (7, 39, 40, 1),
             (50, 300, 2500, 3), (3, 8192, 2048, 2), (3, 8193, 4000, 0), (10, 400, 99, 0),
             (10, 400, 100, 2), (64, 5, 2, 0)]


@pytest.mark.parametrize("rows,length,taps,offset", _RF_CASES)
def test_rows_linear_forward_staging_edges(card, rows, length, taps, offset):
    """The redesigned rows forward equals its plain version bit for bit with
    one launch, far positions (+-1e6, +-3e9) giving zeros and taps at
    i0 = -2, -1, L-1 and L; as the forward of `gather_rows_linear` too."""
    g = torch.Generator(device=card).manual_seed(rows + length + taps)
    flat = torch.randn(offset + rows * length, device=card, generator=g)
    vol = flat[offset:].view(rows, length)
    flat_pos = torch.empty(offset + rows * taps, device=card)
    pos = flat_pos[offset:].view(rows, taps)
    pos.copy_(torch.rand(rows, taps, device=card, generator=g) * (length + 8) - 4)
    edge = torch.tensor([*_LINEAR_FAR, -1.5, -0.5, length - 0.5, length + 0.25], device=card)
    pos[0, : min(taps, 8)] = edge[: min(taps, 8)]
    assert vol.data_ptr() % 16 == pos.data_ptr() % 16 == 4 * offset
    before = tl.gather_rows_linear.launches
    got, want = tl.gather_rows_linear(vol, pos), tl.gather_rows_linear_ref(vol, pos)
    torch.cuda.synchronize()
    assert tl.gather_rows_linear.launches == before + 1
    assert got.shape == (rows, taps) and torch.equal(got, want)
    assert not got[0, : min(taps, 4)].any()


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
