"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests import neither JAX nor the JAX package, so they run on a
machine that has only PyTorch and a card:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a card they skip: a CUDA kernel has no CPU mode.  `chip_smoke.py`
holds the same kernels to their plain versions at the main-path shapes.
"""

import pytest
import torch

from anystereo_tpu_torch.config import ModelConfig
from anystereo_tpu_torch.nn.model import build_model
from anystereo_tpu_torch.config import TrainConfig
from anystereo_tpu_torch.ops import lookup
from anystereo_tpu_torch.ops.kernels.gather import (
    gather_rows,
    gather_rows_hybrid,
    gather_rows_ref,
    scatter_rows_add,
    scatter_rows_add_ref,
)
from anystereo_tpu_torch.ops.kernels.lookup import (
    gather_pyramid_aligned,
    gather_pyramid_aligned_bwd,
    gather_pyramid_aligned_bwd_ref,
    gather_pyramid_aligned_ref,
)
from anystereo_tpu_torch.ops.sampling import set_gather_override
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


@pytest.mark.parametrize("levels", [1, 2, 3])
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


@pytest.mark.parametrize("levels", [1, 2, 3])
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


@pytest.mark.parametrize("impl,gathers", [(None, (0, 1)), ("kernel", (3, 3)), ("torch", (0, 0))])
def test_training_forward_backward_through_kernels(card, impl, gathers):
    """A small fp32 training forward and backward: 2 lookups forward and 2
    backward per iteration; per decode the query gathers the dispatch asks
    for; loss and gradients agree with the all-plain run."""
    model = build_model(ModelConfig(max_disp=32, compute_dtype="float32"), device=card, seed=0)
    tcfg = TrainConfig(train_iters=2)
    g = torch.Generator(device=card).manual_seed(5)
    left = torch.rand(2, 64, 128, 3, device=card, generator=g) * 255
    batch = {"left": left, "right": torch.roll(left, shifts=-4, dims=2),
             "coords": torch.rand(2, 1000, 2, device=card, generator=g) * 2 - 1,
             "scale": torch.tensor([1.5, 2.5], device=card),
             "gt": torch.full((2, 1000), 6.0, device=card), "valid": torch.ones(2, 1000, device=card)}
    kernels = (gather_pyramid_aligned, gather_pyramid_aligned_bwd, gather_rows, scatter_rows_add)

    def run():
        for p in model.parameters():
            p.grad = None
        loss, _ = loss_and_metrics(model, tcfg, batch)
        loss.backward()
        torch.cuda.synchronize()
        return loss.detach(), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}

    before = [k.launches for k in kernels]
    set_gather_override(impl)
    try:
        loss, grads = run()
    finally:
        set_gather_override(None)
    assert [k.launches - b for k, b in zip(kernels, before)] == [4, 4, 2 * gathers[0], 2 * gathers[1]]
    kernel_fn = lookup.gather_pyramid_aligned
    lookup.gather_pyramid_aligned = gather_pyramid_aligned_ref
    set_gather_override("torch")
    try:
        plain_loss, plain_grads = run()
    finally:
        lookup.gather_pyramid_aligned = kernel_fn
        set_gather_override(None)
    torch.testing.assert_close(loss, plain_loss, rtol=1e-5, atol=0)
    assert set(grads) == set(plain_grads)
    for name, want in plain_grads.items():
        assert float((grads[name] - want).norm()) <= 1e-3 * float(want.norm()) + 1e-7, name
