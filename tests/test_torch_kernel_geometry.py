"""The geometry of the kernels, pinned on the CPU at the main paths' shapes:
the window span the aligned lookup's forward stages in shared memory, the
cells its backward accumulates for each (row, level) pair, the scatter-add's
vector width and the gather's copy unit and lane group, which their wrappers
choose in Python."""

import numpy as np
import pytest
import torch

from anystereo_tpu_torch.ops.kernels.gather import gather_unit, scatter_vec
from anystereo_tpu_torch.ops.kernels.lookup import (
    _clamp_bounds,
    gather_pyramid_aligned_bwd_ref,
    gather_pyramid_aligned_ref,
)


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


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("length", [5, 45, 48, 80, 312])
def test_backward_cells_cover_every_nonzero_entry(levels, length):
    """The backward kernel accumulates, for each (row, level) pair, the
    cells floor(base) to floor(base) + taps + 1 and counts any other cell as
    zero.  For each level alone (the cotangent zero at the other levels),
    every nonzero entry of the plain backward lies in one of those cells, at
    random positions over the clamped range and just below integers.  The
    last cell is where a tap goes whose lower cell fp32 rounding of base + k
    moved one up (which the just-below-integer positions give): such a tap
    lands on an integer, so its upper weight is 0 and the cell only ever
    receives g * 0; the kernel keeps it so that its register array is
    indexed in bounds."""
    taps, radius = 9, 4
    lo, hi = _clamp_bounds(length, taps, levels)
    rng = np.random.default_rng(levels * 1000 + length + 7)
    ints = np.arange(int(lo), int(hi) + 1)
    moved = 0
    for x in (rng.uniform(lo, hi, 4000), ints - 2.0 ** -20, ints - 2.0 ** -12):
        x = torch.from_numpy(x.astype(np.float32))
        for lvl in range(levels):
            g = torch.zeros(x.shape[0], levels, taps)
            g[:, lvl] = torch.from_numpy(rng.uniform(0.5, 1.5, (x.shape[0], taps)).astype(np.float32))
            dvol = gather_pyramid_aligned_bwd_ref(x, g.reshape(x.shape[0], -1), length, taps, levels)
            base = x.clamp(lo, hi) * np.float32(2.0 ** -lvl) - np.float32(radius)
            first = torch.floor(base)
            moved += int(sum((torch.floor(base + np.float32(k)) != first + k).sum() for k in range(taps)))
            cell = (torch.arange(length) >> lvl)[None, :]
            first = first.long()[:, None]
            assert not dvol[(cell < first) | (cell > first + taps + 1)].any()
            assert not dvol[cell == first + taps + 1].any()  # g * 0 only
            assert dvol.any() == (length >> lvl > 0)  # an empty pooled row gets nothing
    assert moved > 0


@pytest.mark.parametrize("c,dtype,offset,unit,lanes", [
    (9, torch.float32, 0, 4, 9),       # the disparity table: 36-byte rows
    (40, torch.bfloat16, 0, 16, 5),    # the context latent: 6 queries a warp
    (184, torch.bfloat16, 0, 16, 23),  # the decoder latent: one query a warp
    (184, torch.bfloat16, 2, 2, 32), (184, torch.bfloat16, 4, 4, 32), (184, torch.bfloat16, 8, 4, 32),
    (40, torch.bfloat16, 4, 4, 20), (9, torch.float32, 4, 4, 9), (9, torch.bfloat16, 0, 2, 9),
    (40, torch.float32, 0, 16, 10), (7, torch.bfloat16, 0, 2, 7), (1, torch.float32, 0, 4, 1),
    (512, torch.float32, 0, 16, 32),
])
def test_gather_unit_and_lane_group(c, dtype, offset, unit, lanes):
    """The gather's copy unit (the widest of 16, 4, 2 bytes that divides the
    row and the table's and output's addresses) and the lanes that share a
    query row (a unit each, at most 32)."""
    size = torch.empty((), dtype=dtype).element_size()
    assert gather_unit(c * size, 1024 + offset, 4096) == (unit, lanes)
    assert gather_unit(c * size, 4096, 1024 + offset) == (unit, lanes)


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
