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
from anystereo_tpu_torch.ops import lookup
from anystereo_tpu_torch.ops.kernels.lookup import (
    gather_pyramid_aligned,
    gather_pyramid_aligned_ref,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
