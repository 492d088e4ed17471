"""The geometry of the kernels, pinned on the CPU at the main paths' shapes:
the window span the aligned lookup's forward stages in shared memory, and
the scatter-add's vector width, which its wrapper chooses in Python."""

import numpy as np
import pytest
import torch

from anystereo_tpu_torch.ops.kernels.gather import scatter_vec
from anystereo_tpu_torch.ops.kernels.lookup import _clamp_bounds, gather_pyramid_aligned_ref


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("length", [5, 45, 48, 80, 312])
def test_deepest_window_span_covers_every_tap(levels, length):
    """The kernel copies each row's span [2^D*floor(base_D), +(taps+1)*2^D)
    (D = levels - 1) into shared memory and reads from device memory any
    cell outside it.  In fp32, as the kernel computes them: for positions
    drawn over the clamped range every cell a tap reads lies inside; a
    position just below an integer can round base + k up to the next cell,
    which then lies at most one cell past the span's end."""
    taps, radius = 9, 4
    lo, hi = _clamp_bounds(length, taps, levels)
    rng = np.random.default_rng(levels * 1000 + length)
    ints = np.arange(int(lo), int(hi) + 1)
    top = 2 ** (levels - 1)
    for x, past in ((rng.uniform(lo, hi, 20000), 0), (ints - 2.0 ** -20, 1), (ints - 2.0 ** -12, 1)):
        x = x.astype(np.float32)
        base_d = x * np.float32(1.0 / top) - np.float32(radius)
        origin = np.floor(base_d).astype(np.int64) * top
        for lvl in range(levels):
            width = 2 ** lvl
            base = x * np.float32(1.0 / width) - np.float32(radius)
            for k in range(taps):
                i0 = np.floor(base + np.float32(k)).astype(np.int64)
                assert (i0 * width >= origin).all()
                assert ((i0 + 2) * width <= origin + (taps + 1 + past) * top).all()


@pytest.mark.parametrize("c,dtype,offset,vec", [
    (9, torch.float32, 0, 1),     # the disparity table: 36-byte rows, scalar atomics
    (184, torch.bfloat16, 0, 4),  # the decoder latent: 8-byte loads, one float4 atomic a lane
    (40, torch.bfloat16, 0, 4),   # the context latent
    (184, torch.bfloat16, 2, 1), (184, torch.bfloat16, 4, 2), (184, torch.bfloat16, 8, 4),
    (8, torch.bfloat16, 16, 4),
    (40, torch.float32, 0, 4), (40, torch.float32, 4, 1), (40, torch.float32, 8, 2),
    (4, torch.bfloat16, 0, 4), (7, torch.bfloat16, 0, 1), (33, torch.float32, 0, 1),
    (1, torch.bfloat16, 0, 1),
])
def test_scatter_vector_width(c, dtype, offset, vec):
    assert scatter_vec(c, dtype, 1024 + offset) == vec


@pytest.mark.parametrize("levels", [3, 4, 5])
def test_plain_forward_on_rows_shorter_than_a_cell(levels):
    """L = 5 pools to an empty row from level 3 on: those levels' taps are
    zero (as the kernel gives them), the shallower ones unchanged."""
    g = torch.Generator().manual_seed(1)
    vol, x = torch.randn(33, 5, generator=g), torch.rand(33, generator=g) * 9 - 2
    out = gather_pyramid_aligned_ref(vol, x, 9, levels)
    assert out.shape == (33, levels * 9) and not out[:, 27:].any()
    torch.testing.assert_close(out[:, :27], gather_pyramid_aligned_ref(vol, x, 9, 3)[:, :27], rtol=0, atol=0)
