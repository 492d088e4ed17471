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


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module (a parallel test run puts
    several test processes on the same cores); the count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


# ------------------------------------------- the window-pyramid forward (B4)
#
# `csrc/lookup_window.cu:window_pm_fwd`: a block owns a tile of 32 rows, one
# thread a (row, level) pair.  The pairs' live cells give each row the hull
# of entries it needs and the tile its span [lo, hi), lo rounded down to the
# deepest cell width; the span is staged in chunks (the row rounded up to 16
# entries, at most 128), copying only the 4-row groups (16 bytes) that some
# row needs, or single rows where R % 4 != 0 or the group is the tile's
# ragged end; after a chunk the walk goes on at the first entry a row still
# needs, rounded down.  The mirror below makes the same copies into an array
# of NaNs and forms the taps from it in the kernel's order, so a cell read
# from an entry the rule did not copy comes out NaN and differs from the
# plain version.

PM_ROWS, PM_SPAN = 32, 128
INT_MAX, INT_MIN = 2 ** 31 - 1, -(2 ** 31)


def _pm_chunk(length):
    return min(-(-length // 16) * 16, PM_SPAN)


def _pm_starts(bases, n_lvl, taps):
    """(i0, f) in fp32 as the kernel forms them: floor clamped in float to
    [-(taps+1), n_lvl], then converted."""
    f0 = np.floor(bases)
    return np.clip(f0, np.float32(-(taps + 1)), np.float32(n_lvl)).astype(np.int64), bases - f0


def _mirror_window_pm(vol_t, bases_t, taps, transposed=False):
    """(out, chunks staged, entries copied) of the kernel's rule, in numpy
    fp32: out [R, levels*taps] through the tile's tap stage (layout 0), or
    with `transposed` out [levels*taps, R] stored tap by tap as formed
    (layout 1), NaN where nothing was stored; with `transposed` also the
    count of stores to each output."""
    length, rows = vol_t.shape
    levels = bases_t.shape[0]
    out = np.full((rows, levels * taps), np.nan, np.float32)
    out_t = np.full((levels * taps, rows), np.nan, np.float32)
    stores = np.zeros((levels * taps, rows), np.int64)
    vec = rows % 4 == 0
    chunks = copied = 0
    for r0 in range(0, rows, PM_ROWS):
        nrows = min(PM_ROWS, rows - r0)
        pairs = []  # (lvl, row, i0, f, width, n_lvl)
        first = np.full(PM_ROWS, INT_MAX)
        end = np.full(PM_ROWS, INT_MIN)
        for lvl in range(levels):
            width, n_lvl = 2 ** lvl, length >> lvl
            i0, f = _pm_starts(bases_t[lvl, r0:r0 + nrows], n_lvl, taps)
            for row in range(nrows):
                c0, c1 = max(i0[row], 0), min(i0[row] + taps + 1, n_lvl)
                if c0 < c1:
                    first[row] = min(first[row], c0 * width)
                    end[row] = max(end[row], c1 * width)
                pairs.append([lvl, row, int(i0[row]), f[row], width, n_lvl, np.float32(0), 0])
        live = first < INT_MAX
        top = 2 ** (levels - 1)
        lo = int(first[live].min()) & -top if live.any() else INT_MAX
        hi = int(end[live].max()) if live.any() else INT_MIN
        chunk = _pm_chunk(length)
        stage = np.full((PM_ROWS, levels * taps), np.nan, np.float32)

        def emit(p, s):
            lvl, row, _, f, _, _, prev, m = p
            if m > 0:
                tap = np.float32(np.float32(1) - f) * prev + f * s
                if transposed:  # straight to out[lvl*taps + k, r0 + row]
                    out_t[lvl * taps + m - 1, r0 + row] = tap
                    stores[lvl * taps + m - 1, r0 + row] += 1
                else:
                    stage[row, lvl * taps + m - 1] = tap
            p[6], p[7] = s, m + 1

        j0 = lo
        while j0 < hi:
            n = min(chunk, hi - j0)
            span = np.full((chunk, PM_ROWS), np.nan, np.float32)
            chunks += 1
            for jj in range(n):
                j = j0 + jj
                need = (first <= j) & (j < end)
                for q in range(0, PM_ROWS, 4):
                    rows_q = range(q, q + 4) if vec and q + 4 <= nrows and need[q:q + 4].any() \
                        else [r for r in range(q, q + 4) if need[r]]
                    for r in rows_q:
                        span[jj, r] = vol_t[j, r0 + r]
                        copied += 1
            for p in pairs:
                _, row, i0, _, width, n_lvl, _, _ = p
                while p[7] <= taps:
                    c = i0 + p[7]
                    s = np.float32(0)
                    if c >= 0:
                        e = c * width - j0
                        if c >= n_lvl or e + width > n:
                            break
                        s = span[e, row]
                        for t in range(1, width):
                            s = np.float32(s + span[e + t, row])
                        s = np.float32(s * np.float32(1.0 / width))
                    emit(p, s)
            j1 = j0 + n
            ahead = [max(first[r], j1) for r in range(PM_ROWS) if end[r] > j1]
            j0 = min(ahead) & -top if ahead else hi
        for p in pairs:
            while p[7] <= taps:
                emit(p, np.float32(0))
        out[r0:r0 + nrows] = stage[:nrows]
    if transposed:
        return out_t, chunks, copied, stores
    return out, chunks, copied


def _smooth_x(rows, length, groups):
    """Path-shaped positions: a smooth disparity field d (4 to 40) over image
    rows of w cells; x = d for each run of `groups` rows (the GEV volume,
    w = 80), or x = column - d (the correlation, w = L)."""
    w = 80 if groups > 1 else length
    cells = -(-rows // groups)
    col, row = np.arange(cells) % w, np.arange(cells) // w
    d = 22 + 18 * np.sin(2 * np.pi * (1.5 * col / w + 0.05 * row)) * np.cos(0.1 * row)
    x = np.repeat(d, groups) if groups > 1 else col - d
    return x[:rows].astype(np.float32)


@pytest.mark.parametrize("rows,length,levels,positions", [
    (205, 48, 2, "random"), (205, 48, 2, "path"), (256, 48, 2, "path"),  # the eval GEV rows
    (205, 312, 2, "random"), (256, 312, 2, "path"),   # the eval correlation: several chunks
    (133, 312, 4, "random"), (256, 312, 4, "path"),   # the RAFT correlation
    (130, 80, 2, "random"), (128, 80, 4, "path"),     # the training correlation
    (70, 5, 3, "random"), (70, 5, 4, "random"), (70, 5, 5, "random"),  # L < 2^lvl
    (192, 312, 2, "apart"), (192, 312, 4, "apart"),  # levels' windows apart: odd span starts
    (128, 312, 2, "gap"),  # a stretch no row needs, then a chunk that starts at an odd entry
])
def test_window_pm_staging_rule_reads_only_what_it_copied(rows, length, levels, positions):
    """The kernel's staging rule, mirrored in numpy fp32, equals the plain
    version bit for bit (so every cell a tap reads was copied into the chunk
    that forms it), with far bases (+-1e6, +-3e9) as zero rows; the random
    correlation tiles take several chunks, the path-shaped ones at most two
    (the tile that wraps to the next image row skips the stretch between
    its two parts), the path-shaped GEV tiles one."""
    from anystereo_tpu_torch.ops.kernels.lookup_window import gather_pyramid_window_pm_ref

    rng = np.random.default_rng(rows * length + levels)
    vol_t = rng.standard_normal((length, rows)).astype(np.float32)
    if positions == "random":
        x = rng.uniform(-20, length + 20, rows).astype(np.float32)
    else:
        x = _smooth_x(rows, length, 8 if length == 48 else 1)
    scales = np.array([2.0 ** -lvl for lvl in range(levels)], np.float32)
    bases = (x[None, :] * scales[:, None] - np.float32(4)).astype(np.float32)
    if positions == "apart":  # each level its own start, none at the row's start: a tile's
        # span may begin at an odd entry, and a deeper cell then meets the end of a chunk
        bases = np.stack([rng.uniform(3, (length >> lvl) - 12, rows) for lvl in range(levels)])
        bases = bases.astype(np.float32)
    if positions == "gap":  # half a tile needs [2, 22), the other half [151, 161) and
        # [278, 298): the walk skips to entry 151 (rounded down to 150), and a chunk
        # from 151 would end inside the level-1 cell [278, 280)
        low = (np.arange(rows) % PM_ROWS) < PM_ROWS // 2
        bases = np.stack([np.where(low, 6.5, 151.5), np.where(low, 1.25, 139.25)]).astype(np.float32)
    bases[:, :4] = np.array([-1e6, 1e6, -3e9, 3e9], np.float32)[None, :]
    got, chunks, copied = _mirror_window_pm(vol_t, bases, 9)
    want = gather_pyramid_window_pm_ref(torch.from_numpy(vol_t), torch.from_numpy(bases), 9).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[:4].any()
    tiles = -(-rows // PM_ROWS)
    if length == 312 and positions in ("random", "apart", "gap"):
        assert chunks > tiles
    if length == 312 and positions == "path":
        assert chunks <= 2 * tiles
    if length == 48 and positions == "path":
        assert chunks == tiles and copied < 0.75 * vol_t.size  # about the windows, not whole rows


def _window_bases(rng, rows, length, levels, taps, positions):
    """[levels, R] fp32 window starts x * 2^-lvl - taps // 2 at random or
    path-shaped x, with the first rows at +-1e6 and +-3e9."""
    if positions == "random":
        x = rng.uniform(-20, length + 20, rows).astype(np.float32)
    else:
        x = _smooth_x(rows, length, 8 if length == 48 else 1)
    scales = np.array([2.0 ** -lvl for lvl in range(levels)], np.float32)
    bases = (x[None, :] * scales[:, None] - np.float32(taps // 2)).astype(np.float32)
    bases[:, :4] = np.array([-1e6, 1e6, -3e9, 3e9], np.float32)[None, :]
    return bases


@pytest.mark.parametrize("rows,length,levels,taps,positions", [
    (205, 48, 2, 9, "random"), (256, 48, 2, 9, "path"),  # the eval GEV rows
    (205, 312, 2, 9, "random"), (133, 312, 4, 9, "random"),  # the correlations: several chunks
    (130, 80, 1, 9, "random"), (97, 80, 3, 9, "path"), (70, 80, 5, 9, "random"),
    (75, 39, 2, 9, "random"), (75, 41, 3, 17, "random"),  # L % 4 != 0, wider windows
    (70, 5, 3, 9, "random"), (70, 5, 5, 17, "random"),  # L shorter than a deepest cell
    (64, 312, 2, 17, "path"),
])
def test_window_t_forward_stores_each_tap_once(rows, length, levels, taps, positions):
    """B5's forward (`window_t_fwd`: B4's staged walk, each tap stored to
    out [levels*taps, R] as it is formed), mirrored in numpy fp32 into a
    NaN-filled output, stores every tap once and equals the plain version
    bit for bit, far bases (+-1e6, +-3e9) as zero columns, ragged tiles."""
    from anystereo_tpu_torch.ops.kernels.lookup_window import gather_pyramid_window_t_ref

    rng = np.random.default_rng(rows * length + levels * taps + 1)
    vol_t = rng.standard_normal((length, rows)).astype(np.float32)
    bases = _window_bases(rng, rows, length, levels, taps, positions)
    got, _, _, stores = _mirror_window_pm(vol_t, bases, taps, transposed=True)
    want = gather_pyramid_window_t_ref(torch.from_numpy(vol_t), torch.from_numpy(bases), taps).numpy()
    assert (stores == 1).all()
    np.testing.assert_array_equal(got, want)
    assert not got[:, :4].any()


# ------------------------------------- the window-pyramid backward (B4, B5)
#
# `csrc/lookup_window.cu:window_t_bwd`: a block of 4 warps owns a tile of 32
# rows (lane = row) and a range of L.  It copies the tile's cotangent into
# [levels*taps][33] (layout 0: the tile's rows contiguous; layout 1: a run of
# 32 rows a channel, zeros past the tile's end), forms each (level, row)'s
# window start and the slot coefficients [level][taps + 2][32] of the cells
# its range falls in (slot taps + 1 and cells outside [0, L >> lvl) zero).
# Each warp walks chunks of max(2^(levels-1), 4) entries: per level and cell
# it reads the coefficient of slot min(cell - i0, taps + 1) once and adds
# it into the cell's entries, levels ascending; a chunk outside the tile's
# hull (the entries of every row's live cells at every level) is stored as
# zeros.  L is split into equal ranges (a whole number of chunks, at least
# one a warp) while the tiles give the card fewer than 4 blocks an SM.  The
# mirror stages into NaN-filled arrays, so a coefficient or cotangent read
# that the rule did not write comes out NaN, and counts each entry's writes.

BWD_ROWS, BWD_WARPS, BWD_BLOCKS_PER_SM = 32, 4, 4


def _t_bwd_span(rows, length, chunk, sms):
    tiles = -(-rows // BWD_ROWS)
    wanted = -(-(BWD_BLOCKS_PER_SM * sms) // tiles)
    most = -(-length // (BWD_WARPS * chunk))
    span = -(-length // min(wanted, most))
    return -(-span // chunk) * chunk


def _mirror_window_t_bwd(bases_t, g, length, taps, pixel_major, sms):
    """(dvol_t [L, R], writes [L, R], ranges) of the kernel's tiles, ranges,
    coefficient table and chunk walk, in numpy fp32."""
    levels, rows = bases_t.shape
    chans, slots, chunk = levels * taps, taps + 2, max(2 ** (levels - 1), 4)
    span = _t_bwd_span(rows, length, chunk, sms)
    dvol = np.full((length, rows), np.nan, np.float32)
    writes = np.zeros((length, rows), np.int64)
    one, lanes = np.float32(1), np.arange(BWD_ROWS)
    for r0 in range(0, rows, BWD_ROWS):
        nrows = min(BWD_ROWS, rows - r0)
        gs = np.full((chans, BWD_ROWS + 1), np.nan, np.float32)
        if pixel_major:  # the tile's rows, contiguous in g [R, chans]
            tile = g.reshape(-1)[r0 * chans:(r0 + nrows) * chans]
            for i, v in enumerate(tile):
                gs[i % chans, i // chans] = v
        else:  # g [chans, R]: 32 rows a channel, zeros past the tile's end
            gs[:, :BWD_ROWS] = 0
            gs[:, :nrows] = g[:, r0:r0 + nrows]
        i0 = np.zeros((levels, BWD_ROWS), np.int64)
        f = np.zeros((levels, BWD_ROWS), np.float32)
        for lvl in range(levels):
            i0[lvl] = length >> lvl  # past the tile's end: no window
            i0[lvl, :nrows], f[lvl, :nrows] = _pm_starts(bases_t[lvl, r0:r0 + nrows], length >> lvl, taps)
        for e0 in range(0, length, span):
            e1 = min(e0 + span, length)
            coef = np.full((levels, slots, BWD_ROWS), np.nan, np.float32)
            lo, hi = INT_MAX, INT_MIN
            for lvl in range(levels):
                n_lvl = length >> lvl
                for m in range(slots):
                    cell = i0[lvl] + m
                    dead = (m > taps) | (cell < 0) | (cell >= n_lvl)
                    formed = ~dead & (cell >= e0 >> lvl) & (cell <= (e1 - 1) >> lvl)
                    c = np.zeros(BWD_ROWS, np.float32)
                    if m < taps:
                        c = (one - f[lvl]) * gs[lvl * taps + m, :BWD_ROWS]
                    if 1 <= m <= taps:
                        c = c + f[lvl] * gs[lvl * taps + m - 1, :BWD_ROWS]
                    c = c * np.float32(1.0 / 2 ** lvl)
                    coef[lvl, m] = np.where(dead, np.float32(0), np.where(formed, c, coef[lvl, m]))
                c0, c1 = np.maximum(i0[lvl], 0), np.minimum(i0[lvl] + taps + 1, n_lvl)
                live = c0 < c1
                if live.any():
                    lo, hi = min(lo, int((c0[live] << lvl).min())), max(hi, int((c1[live] << lvl).max()))
            for jc in range(e0, e1, chunk):  # each warp a chunk in turn
                acc = np.zeros((chunk, BWD_ROWS), np.float32)
                if jc < hi and jc + chunk > lo:
                    for lvl in range(levels):
                        for q in range(chunk >> lvl):
                            m = (jc >> lvl) + q - i0[lvl]
                            m = np.where((m < 0) | (m > taps + 1), taps + 1, m)
                            c = coef[lvl, m, lanes]
                            for t in range(1 << lvl):
                                acc[(q << lvl) + t] = acc[(q << lvl) + t] + c
                for t in range(chunk):
                    if jc + t < e1:
                        dvol[jc + t, r0:r0 + nrows] = acc[t, :nrows]
                        writes[jc + t, r0:r0 + nrows] += 1
    return dvol, writes, -(-length // span)


@pytest.mark.parametrize("rows,length,levels,taps,positions", [
    (200, 80, 4, 9, "path"),      # the RAFT training shape's tiles, L split in 3
    (200, 80, 4, 9, "random"),
    (70, 312, 4, 9, "random"),    # the eval correlation's row, a ragged tile
    (70, 312, 2, 9, "path"),
    (75, 48, 2, 9, "path"),       # the GEV row: 8 rows a cell share one x
    (41, 39, 3, 17, "random"),    # L % 4 != 0, wider windows
    (33, 21, 5, 1, "random"),     # one tap, cells of 16 entries
    (40, 5, 5, 9, "random"),      # rows shorter than a cell from level 3 on
    (37, 2, 2, 9, "random"),      # L 2: one level-1 cell
    (35, 1, 1, 9, "random"),
    (64, 300, 3, 9, "gap"),       # half a tile far along: a stretch of zeros
])
@pytest.mark.parametrize("sms", [1, 132])
def test_window_t_backward_tiles_match_plain(rows, length, levels, taps, positions, sms):
    """The backward's staging, coefficient table, hulls and chunk walk,
    mirrored in numpy fp32 for both layouts, write every entry once and
    equal the plain versions bit for bit, far bases (+-1e6, +-3e9) as zero
    columns; the split of L over ranges as the card's SM count (1 or 132)
    asks it of these few tiles."""
    from anystereo_tpu_torch.ops.kernels.lookup_window import (
        gather_pyramid_window_pm_bwd_ref,
        gather_pyramid_window_t_bwd_ref,
    )

    rng = np.random.default_rng(rows * length + levels * taps)
    if positions == "random":
        x = rng.uniform(-20, length + 20, rows).astype(np.float32)
    else:
        x = _smooth_x(rows, length, 8 if length == 48 else 1)
    scales = np.array([2.0 ** -lvl for lvl in range(levels)], np.float32)
    bases = (x[None, :] * scales[:, None] - np.float32(taps // 2)).astype(np.float32)
    if positions == "gap":  # rows 16-31 of each tile far along the row
        far_along = (np.arange(rows) % BWD_ROWS) >= BWD_ROWS // 2
        bases[:, far_along] = (np.float32(250.5) * scales[:, None]).astype(np.float32)
        bases[:, ~far_along] = np.float32(1.25)
    bases[:, :4] = np.array([-1e6, 1e6, -3e9, 3e9], np.float32)[None, :]
    g = rng.standard_normal((rows, levels * taps)).astype(np.float32)
    want = gather_pyramid_window_pm_bwd_ref(torch.from_numpy(bases), torch.from_numpy(g), length, taps).numpy()
    want_t = gather_pyramid_window_t_bwd_ref(torch.from_numpy(bases), torch.from_numpy(g.T.copy()),
                                             length, taps).numpy()
    np.testing.assert_array_equal(want_t, want)
    for pixel_major, cot in ((True, g), (False, g.T.copy())):
        got, writes, ranges = _mirror_window_t_bwd(bases, cot, length, taps, pixel_major, sms)
        assert (writes == 1).all()
        np.testing.assert_array_equal(got, want)
        assert not got[:, :4].any()
    if (rows, length, levels) == (200, 80, 4):  # 7 tiles: whole rows for 4 blocks, 3 ranges for 528
        assert ranges == (1 if sms == 1 else 3)
    if rows >= BWD_BLOCKS_PER_SM * BWD_ROWS * sms:
        assert ranges == 1


# ------------------------------------------ the row-major window backward (B6)
#
# `csrc/lookup_window.cu:window_rows_bwd`: a block of ROWS_BWD_THREADS
# threads owns a tile of consecutive rows (a multiple of 4).  It copies the
# tile's cotangent, rows*levels*taps contiguous floats, into shared memory at
# its own offset within 16 bytes (4-byte copies up to a 16-byte boundary,
# 16-byte copies, a 4-byte tail) and the tile's bases, forms each (row,
# level)'s i0 and its taps + 2 slot coefficients [row][level][slot] (slot
# taps + 1 and cells outside [0, L >> lvl) zero), then walks the tile's dvol,
# rows*L contiguous entries: a scalar head up to a 16-byte boundary, four
# entries a thread at a time stored as one 16-byte vector, each thread
# stepping its (row, j) by the block's stride, and a scalar tail.  An entry
# sums, levels ascending, the coefficient of slot min((j >> lvl) - i0,
# taps + 1) as unsigned.  Where L % 4 == 0 and there is no head, a group of
# four starts at a j that is a multiple of 4 and reads cell (j >> lvl) +
# (q >> lvl) for its entry q, once a cell.  The mirror stages into NaN-filled
# arrays and writes a NaN-filled dvol, counting copies and stores.

ROWS_BWD_THREADS = 128


def _mirror_window_rows_bwd(bases, g, length, taps, tile, g_off=0, d_off=0):
    """(dvol [R, L], stores [R*L]) of the kernel's tiles, staging, table and
    store order, in numpy fp32, for a cotangent and a dvol that start
    `g_off` and `d_off` floats past a 16-byte boundary."""
    rows, levels = bases.shape
    chans, slots = levels * taps, taps + 2
    gflat = g.reshape(-1)
    dvol = np.full(rows * length, np.nan, np.float32)
    stores = np.zeros(rows * length, np.int64)
    one = np.float32(1)
    for r0 in range(0, rows, tile):
        nrows = min(tile, rows - r0)
        pairs = nrows * levels
        # the staged cotangent: element i at gs[shift + i]
        shift = (g_off + r0 * chans) % 4
        gs = np.full(tile * chans + 4, np.nan, np.float32)
        copies = np.zeros(tile * chans + 4, np.int64)
        n = nrows * chans
        head = min(n, (4 - shift) % 4)
        vecs = (n - head) // 4
        for i in range(vecs):
            a = head + 4 * i
            assert (shift + a) % 4 == 0 and (g_off + r0 * chans + a) % 4 == 0  # both ends aligned
            gs[shift + a:shift + a + 4] = gflat[r0 * chans + a:r0 * chans + a + 4]
            copies[shift + a:shift + a + 4] += 1
        for e in [*range(head), *range(head + 4 * vecs, n)]:
            gs[shift + e] = gflat[r0 * chans + e]
            copies[shift + e] += 1
        assert (copies[shift:shift + n] == 1).all()
        base = np.full(tile * levels, np.nan, np.float32)
        base[:pairs] = bases[r0:r0 + nrows].reshape(-1)
        i0s = np.full(tile * levels, INT_MIN, np.int64)
        coef = np.full(tile * levels * slots, np.nan, np.float32)
        for i in range(pairs * slots):
            p, m = divmod(i, slots)
            lvl = p % levels
            n_lvl = length >> lvl
            i0, f = _pm_starts(base[p:p + 1], n_lvl, taps)
            i0, f = int(i0[0]), f[0]
            if m == 0:
                i0s[p] = i0
            c = np.float32(0)
            if m <= taps and 0 <= i0 + m < n_lvl:
                gp = gs[shift + p * taps:]
                if m < taps:
                    c = (one - f) * gp[m]
                if m >= 1:
                    c = np.float32(c + f * gp[m - 1])
                c = np.float32(c * np.float32(1.0 / 2 ** lvl))
            coef[i] = c
        # the walk: which thread stores which entries, in the kernel's steps
        total, dst = nrows * length, r0 * length
        lead = min(total, (4 - (d_off + dst) % 4) % 4)
        nvec = (total - lead) // 4
        fast = length % 4 == 0 and lead == 0  # groups read once a cell
        where = list(range(lead))  # tile-relative entries, in store order
        group = [(e, 0) for e in where]  # (the first entry of its group of four, its place)
        step = 4 * ROWS_BWD_THREADS
        step_rows, step_j = divmod(step, length)
        for tid in range(ROWS_BWD_THREADS):
            row, j = divmod(lead + 4 * tid, length)
            for v in range(tid, nvec, ROWS_BWD_THREADS):
                assert (d_off + dst + lead + 4 * v) % 4 == 0  # a 16-byte store
                rr, jj = row, j
                for q in range(4):
                    assert rr * length + jj == lead + 4 * v + q
                    where.append(rr * length + jj)
                    group.append((j, q) if fast else (jj, 0))
                    jj += 1
                    if jj == length:
                        jj, rr = 0, rr + 1
                row, j = row + step_rows, j + step_j
                if j >= length:
                    j, row = j - length, row + 1
        where += list(range(lead + 4 * nvec, total))
        group += [(e % length, 0) for e in range(lead + 4 * nvec, total)]
        e = np.array(where, np.int64)
        row = e // length
        j0, q = np.array(group, np.int64).T
        acc = np.zeros(e.shape, np.float32)
        for lvl in range(levels):
            cell = (j0 >> lvl) + (q >> lvl)
            m = np.minimum((cell - i0s[row * levels + lvl]).astype(np.uint32), np.uint32(taps + 1))
            acc = acc + coef[(row * levels + lvl) * slots + m.astype(np.int64)]
        dvol[dst + e] = acc
        np.add.at(stores, dst + e, 1)
    return dvol.reshape(rows, length), stores


@pytest.mark.parametrize("rows,length,levels,taps,positions", [
    (75, 48, 2, 9, "path"), (77, 48, 2, 9, "random"),   # the eval GEV row
    (37, 312, 2, 9, "random"), (41, 312, 4, 9, "path"),  # the correlations, ragged tiles
    (70, 80, 1, 9, "random"), (70, 80, 3, 17, "random"), (45, 80, 5, 9, "random"),
    (53, 39, 2, 9, "random"), (51, 41, 3, 17, "random"),  # L % 4 != 0: rows off the 16-byte grid
    (40, 5, 3, 9, "random"), (40, 5, 5, 17, "random"),   # L shorter than a deepest cell
    (35, 2, 2, 9, "random"), (33, 1, 1, 9, "random"), (29, 21, 5, 1, "random"),
])
@pytest.mark.parametrize("tile,g_off,d_off", [(8, 0, 0), (16, 1, 0), (32, 3, 2), (64, 2, 0)])
def test_window_rows_backward_tiles_match_plain(rows, length, levels, taps, positions, tile, g_off, d_off):
    """B6's backward, mirrored in numpy fp32 (the staged cotangent with its
    16-byte head and tail, the coefficient table, the clamped slot lookup,
    the vector walk with a scalar head and tail), stores every entry once
    and equals the plain version bit for bit, far bases (+-1e6, +-3e9) as
    zero rows; tiles of 8 to 64 rows (a ragged last one), cotangent and
    dvol at each offset within 16 bytes (a dvol off the 16-byte grid, or L
    % 4 != 0, takes the walk entry by entry; the others read once a cell)."""
    from anystereo_tpu_torch.ops.kernels.lookup_window import gather_pyramid_window_bwd_ref

    rng = np.random.default_rng(rows * length + levels * taps)
    bases = np.ascontiguousarray(_window_bases(rng, rows, length, levels, taps, positions).T)
    g = rng.standard_normal((rows, levels * taps)).astype(np.float32)
    want = gather_pyramid_window_bwd_ref(torch.from_numpy(bases), torch.from_numpy(g), length, taps).numpy()
    got, stores = _mirror_window_rows_bwd(bases, g, length, taps, tile, g_off, d_off)
    assert (stores == 1).all()
    np.testing.assert_array_equal(got, want)
    assert not got[:4].any()


# ------------------------------------------- the row-major window forward (B6)
#
# `csrc/lookup_window.cu:window_rows_fwd`: a block owns a tile of
# consecutive rows (8 to 64).  A thread a row forms the row's hull, the
# entries [lo, hi) of the live cells of its windows at every level (empty
# where every window is dead), in copy units: 16-byte groups where L % 4 == 0
# and the volume starts on a 16-byte boundary, entries where not.  A hull
# that fits the row's slot of rows_fwd_slot(levels, taps) entries (the
# deepest window and 6 more, a multiple of 4) is copied into it from its
# first unit, ROWS_FWD_LANES consecutive threads a row; a wider one (the
# levels' windows apart) is not copied, and that row's cells are read from
# the volume.  A thread a (level, row) forms each cell of its window once (a
# dead cell is zero and reads nothing) and its taps into a tap stage at their
# offset within 16 bytes in `out`, which the block stores as a scalar head,
# 16-byte vectors and a scalar tail.  The mirror stages into NaN-filled
# slots and writes a NaN-filled output, counting copies and stores.

ROWS_FWD_LANES = 8


def _rows_fwd_slot(levels, taps):
    return ((taps + 1 << levels - 1) + 6 + 3) // 4 * 4


def _mirror_window_rows_fwd(vol, bases, taps, tile, vol_off=0, out_off=0):
    """(out [R, levels*taps], copies [R, L], stores [R*levels*taps],
    unstaged rows) of the kernel's tiles, hulls, slots, taps and store order
    in numpy fp32, for a volume and an output that start `vol_off` and
    `out_off` floats past a 16-byte boundary."""
    rows, length = vol.shape
    levels = bases.shape[1]
    chans, slot = levels * taps, _rows_fwd_slot(levels, taps)
    vec, unit = (True, 4) if length % 4 == 0 and vol_off == 0 else (False, 1)
    out = np.full(rows * chans, np.nan, np.float32)
    stores = np.zeros(rows * chans, np.int64)
    copies = np.zeros((rows, length), np.int64)
    unstaged = np.zeros(rows, bool)
    one = np.float32(1)
    for r0 in range(0, rows, tile):
        nrows = min(tile, rows - r0)
        stage = np.full((tile, slot), np.nan, np.float32)
        starts = [_pm_starts(bases[r0:r0 + nrows, lvl], length >> lvl, taps) for lvl in range(levels)]
        first = np.zeros(nrows, np.int64)
        for row in range(nrows):
            lo, hi = length, 0
            for lvl, (i0, _) in enumerate(starts):
                c0, c1 = max(i0[row], 0), min(i0[row] + taps + 1, length >> lvl)
                if c0 < c1:
                    lo, hi = min(lo, c0 << lvl), max(hi, c1 << lvl)
            if vec:
                lo, hi = lo >> 2, (hi + 3) >> 2
            first[row] = unit * lo
            if hi - lo > slot // unit:
                unstaged[r0 + row] = True
                continue
            for lane in range(ROWS_FWD_LANES if lo < hi else 0):
                u = np.arange(lo + lane, hi, ROWS_FWD_LANES)
                assert (unit * u + unit <= length).all()  # inside the row
                j = (unit * u[:, None] + np.arange(unit)).ravel()
                stage[row, j - first[row]] = vol[r0 + row, j]
                np.add.at(copies[r0 + row], j, 1)
        # the taps, a (level, row) at a time in the kernel; here a level at a time
        shift = (out_off + r0 * chans) % 4
        ts = np.full(tile * chans + 4, np.nan, np.float32)
        rr = np.arange(nrows)
        staged = ~unstaged[r0:r0 + nrows]
        for lvl, (i0, f) in enumerate(starts):
            width, n_lvl = 2 ** lvl, length >> lvl

            def at(rows_, j):
                got = vol[r0 + rows_, j]  # the rows read from the volume
                inside = staged[rows_]
                got[inside] = stage[rows_[inside], j[inside] - first[rows_[inside]]]
                return got

            def cell(c):
                live = (c >= 0) & (c < n_lvl)
                e = c[live] * width
                acc = at(rr[live], e)
                for t in range(1, width):
                    acc = acc + at(rr[live], e + t)
                s = np.zeros(nrows, np.float32)
                s[live] = acc * np.float32(1.0 / width)
                return s

            prev = cell(i0)
            for k in range(taps):
                cur = cell(i0 + k + 1)
                ts[shift + rr * chans + lvl * taps + k] = (one - f) * prev + f * cur
                prev = cur
        total, dst = nrows * chans, r0 * chans
        lead = min(total, (4 - shift) % 4)
        nvec = (total - lead) // 4
        if nvec:
            assert (out_off + dst + lead) % 4 == 0 and (shift + lead) % 4 == 0  # 16-byte stores
        for a, b in ((0, lead), (lead, lead + 4 * nvec), (lead + 4 * nvec, total)):
            out[dst + a:dst + b] = ts[shift + a:shift + b]
            stores[dst + a:dst + b] += 1
    return out.reshape(rows, chans), copies, stores, unstaged


@pytest.mark.parametrize("rows,length,levels,taps,positions", [
    (75, 48, 2, 9, "path"), (77, 48, 2, 9, "random"),   # the eval GEV row
    (37, 312, 2, 9, "random"), (41, 312, 4, 9, "path"),  # the correlations, ragged tiles
    (70, 80, 1, 9, "random"), (70, 80, 3, 17, "random"), (45, 80, 5, 9, "random"),
    (53, 45, 2, 9, "random"), (51, 45, 3, 17, "path"),  # L % 4 != 0: 4-byte copies
    (40, 5, 3, 9, "random"), (40, 5, 5, 17, "random"),   # L shorter than a deepest cell
    (29, 21, 5, 1, "random"), (33, 48, 3, 1, "path"),
    (67, 312, 2, 9, "apart"), (39, 80, 4, 1, "apart"),   # hulls wider than a slot
])
@pytest.mark.parametrize("tile,vol_off,out_off", [(8, 0, 0), (16, 1, 3), (32, 3, 2), (64, 0, 1)])
def test_window_rows_forward_staging_matches_plain(rows, length, levels, taps, positions, tile,
                                                   vol_off, out_off):
    """B6's forward, mirrored in numpy fp32 (each row's hull copied into a
    NaN-filled slot by 16-byte groups or entry by entry, or read from the
    volume where it does not fit, the taps from there, the tap stage stored
    with a scalar head and tail), copies each staged entry once, stores
    every output once and equals the plain version bit for bit, far bases
    (+-1e6, +-3e9) as zero rows that read nothing; tiles of 8 to 64 rows (a
    ragged last one), a volume off the 16-byte grid (4-byte copies), an
    output at each offset, each level's window apart from the others."""
    from anystereo_tpu_torch.ops.kernels.lookup_window import gather_pyramid_window_ref

    rng = np.random.default_rng(rows * length + levels * taps + tile)
    if positions == "apart":  # each level its own start
        bases = np.stack([rng.uniform(-3, (length >> lvl) + 3, rows) for lvl in range(levels)], 1)
        bases = bases.astype(np.float32)
        bases[:4] = np.array([-1e6, 1e6, -3e9, 3e9], np.float32)[:, None]
    else:
        bases = np.ascontiguousarray(_window_bases(rng, rows, length, levels, taps, positions).T)
    vol = rng.standard_normal((rows, length)).astype(np.float32)
    want = gather_pyramid_window_ref(torch.from_numpy(vol), torch.from_numpy(bases), taps).numpy()
    got, copies, stores, unstaged = _mirror_window_rows_fwd(vol, bases, taps, tile, vol_off, out_off)
    assert (stores == 1).all() and (copies <= 1).all()
    np.testing.assert_array_equal(got, want)
    assert not got[:4].any() and not copies[:4].any()  # far bases: zeros, nothing read
    # what is copied is the hull of the entries some window of the row needs
    # (rounded out to 16-byte groups where the copies are whole groups), or
    # nothing where that does not fit the slot
    starts = np.floor(bases).clip(-(taps + 1), length).astype(np.int64)
    j = np.arange(length)
    lo, hi = np.full(rows, length), np.zeros(rows, np.int64)
    for lvl in range(levels):
        n = length >> lvl
        a, b = starts[:, lvl].clip(0, n) << lvl, (starts[:, lvl] + taps + 1).clip(0, n) << lvl
        lo, hi = np.where(a < b, np.minimum(lo, a), lo), np.where(a < b, np.maximum(hi, b), hi)
    if length % 4 == 0 and vol_off == 0:
        lo, hi = lo & -4, np.where(hi > lo, (hi + 3) & -4, hi)
    hull = (j >= lo[:, None]) & (j < hi[:, None]) & ~unstaged[:, None]
    np.testing.assert_array_equal(copies, hull)
    assert unstaged.any() == (positions == "apart")  # the main path's windows nest


# ------------------------------------------------ the rows linear forward (B8)
#
# `csrc/lookup_linear.cu:rows_linear_fwd`: a block owns a row and a range of
# its taps (equal ranges of at most 2,048, a multiple of 4).  It copies the
# row into shared memory at the same offset within 16 bytes as in the
# volume (a 4-byte head up to the first 16-byte boundary, 16-byte copies, a
# 4-byte tail), loads its taps' positions as up to two float4s a thread
# between a scalar head and tail (all scalars where positions and output sit at
# different offsets within 16 bytes) and forms the taps from the staged row.
# Rows longer than 8,192 entries or with fewer than L/4 taps take a thread a
# tap.  The mirror copies into a NaN-filled stage and writes a NaN-filled
# output, counting copies and writes.

ROWS_FWD_STAGED, ROWS_FWD_VECS = 8192, 2
ROWS_FWD_MOST = 4 * 256 * ROWS_FWD_VECS


def _mirror_rows_linear_fwd(vol, pos, vol_off, pos_off, out_off):
    """(out [R, K], copies [R, L], writes [R, K]) of the staged forward in
    numpy fp32, for arrays that start `*_off` floats past a 16-byte
    boundary."""
    rows, length = vol.shape
    taps = pos.shape[1]
    assert length <= ROWS_FWD_STAGED and 4 * taps >= length
    ranges = -(-taps // ROWS_FWD_MOST)
    span = -(-(-(-taps // ranges)) // 4) * 4
    vec = (pos_off - out_off) % 4 == 0
    out = np.full((rows, taps), np.nan, np.float32)
    copies = np.zeros((rows, length), np.int64)
    writes = np.zeros((rows, taps), np.int64)
    one = np.float32(1)
    for r in range(rows):
        shift = (vol_off + r * length) % 4
        head = min(length, (4 - shift) % 4)
        vecs = (length - head) // 4
        stage = np.full(length + 3, np.nan, np.float32)
        for i in [*range(head), *range(head + 4 * vecs, length)]:  # 4-byte copies
            stage[shift + i] = vol[r, i]
            copies[r, i] += 1
        for v in range(vecs):
            a = head + 4 * v
            assert (shift + a) % 4 == 0 and (vol_off + r * length + a) % 4 == 0  # both ends aligned
            stage[shift + a:shift + a + 4] = vol[r, a:a + 4]
            copies[r, a:a + 4] += 1
        row = stage[shift:shift + length]
        for k0 in range(0, taps, span):
            n = min(span, taps - k0)
            phead = min(n, (4 - (pos_off + r * taps + k0) % 4) % 4) if vec else n
            pvecs = (n - phead) // 4 if vec else 0
            assert pvecs <= 256 * ROWS_FWD_VECS  # at most two float4s a thread
            for k in range(k0, k0 + n):
                p = pos[r, k]
                f0 = np.floor(p)
                w = p - f0
                i0 = int(np.clip(f0, np.float32(-2), np.float32(length)))
                lower = row[i0] if 0 <= i0 < length else np.float32(0)
                upper = row[i0 + 1] if 0 <= i0 + 1 < length else np.float32(0)
                out[r, k] = lower * (one - w) + upper * w
                writes[r, k] += 1
    return out, copies, writes


@pytest.mark.parametrize("rows,length,taps,offsets", [
    (4, 1242, 1242, (0, 0, 0)),   # the occlusion warp's row: one range
    (5, 1242, 1242, (1, 2, 2)),   # rows off a 16-byte boundary, positions too
    (5, 39, 39, (3, 1, 0)),       # L % 4 != 0, positions and output apart: scalars
    (3, 78, 2500, (2, 0, 0)),     # K > L: two ranges of 1,252 and 1,248
    (6, 5, 3, (1, 3, 3)),
    (1, 300, 75, (0, 0, 0)),      # K = L / 4
])
def test_rows_linear_forward_staging_matches_plain(rows, length, taps, offsets):
    """The staged rows forward, mirrored in numpy fp32, copies each entry of
    a row once, writes each tap once and equals the plain version bit for
    bit, far positions and i0 at -2, -1, L-1 and L included."""
    from anystereo_tpu_torch.ops.kernels.lookup_linear import gather_rows_linear_ref

    rng = np.random.default_rng(rows * length + taps)
    vol = rng.standard_normal((rows, length)).astype(np.float32)
    pos = rng.uniform(-4, length + 4, (rows, taps)).astype(np.float32)
    pos[0, :min(taps, 8)] = np.array([-3e9, 3e9, -1e6, 1e6, -1.5, -0.5, length - 0.5, length + 0.25],
                                     np.float32)[:min(taps, 8)]
    got, copies, writes = _mirror_rows_linear_fwd(vol, pos, *offsets)
    assert (copies == 1).all() and (writes == 1).all()
    want = gather_rows_linear_ref(torch.from_numpy(vol), torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------ the window linear forward (B7)
#
# `csrc/lookup_linear.cu:window_linear_fwd`: each warp owns a tile of 32 or
# 16 rows, the most that still gives each SM 16 warps; a row's window,
# taps+1 entries from floor(base) (zeros outside [0, L)), is staged once in
# the warp's shared memory and the tile's taps are formed from it in output
# order.  A block holds 4 warps and at most 48 KB, so windows of up to 94
# entries are staged.  Fewer rows than 16-row tiles need, and wider
# windows, take a thread a tap (`window_linear_fwd_taps`), the plain
# version's own order.  The card tests (`test_torch_cuda.py`) take the tile
# heights' edges at 132 SMs and the widest staged window.

def _mirror_window_linear(vol, base, taps, tile):
    """The kernel's staging and tap order in numpy fp32."""
    rows, length = vol.shape
    out = np.empty((rows, taps), np.float32)
    f0 = np.floor(base)
    starts = np.clip(f0, np.float32(-(taps + 1)), np.float32(length)).astype(np.int64)
    fs = base - f0
    for r0 in range(0, rows, tile):
        nrows = min(tile, rows - r0)
        win = np.zeros((nrows, taps + 1), np.float32)
        for i in range(nrows * (taps + 1)):
            row, m = divmod(i, taps + 1)
            j = starts[r0 + row] + m
            if 0 <= j < length:
                win[row, m] = vol[r0 + row, j]
        flat = out[r0:r0 + nrows].reshape(-1)
        for e in range(nrows * taps):
            row, k = divmod(e, taps)
            f = fs[r0 + row]
            flat[e] = np.float32(np.float32(1) - f) * win[row, k] + f * win[row, k + 1]
    return out


@pytest.mark.parametrize("rows,length,taps", [(300, 48, 9), (150, 312, 9), (70, 5, 9), (65, 80, 1),
                                              (65, 80, 17), (40, 39, 93)])
def test_window_linear_staging_matches_plain(rows, length, taps):
    """The staged window and the output order, mirrored in numpy fp32 with
    tiles of 16 and 32 rows, equal the plain version bit for bit, far
    starts included."""
    from anystereo_tpu_torch.ops.kernels.lookup_linear import gather_window_linear_ref

    rng = np.random.default_rng(rows + length + taps)
    vol = rng.standard_normal((rows, length)).astype(np.float32)
    base = rng.uniform(-taps - 3, length + 3, rows).astype(np.float32)
    base[:4] = np.array([-3e9, 3e9, -1e6, 1e6], np.float32)
    want = gather_window_linear_ref(torch.from_numpy(vol), torch.from_numpy(base), taps).numpy()
    for tile in (16, 32):
        np.testing.assert_array_equal(_mirror_window_linear(vol, base, taps, tile), want)


# ------------------------------------------------ the window linear backward (B7)
#
# `csrc/lookup_linear.cu:window_linear_bwd`: each warp owns a tile of 32,
# 16, 8 or 4 rows; its lanes form each row's taps + 1 coefficients once,
# (1 - f)*g_j + f*g_{j-1} with the absent terms left out, then write the
# tile's tile*L entries of dvol (contiguous) four at a time, each lane
# stepping its (row, l) by 128 entries, and a scalar tail.  The mirror
# writes into a NaN-filled dvol and counts each entry's writes, so an entry
# missed or written twice shows.

def _mirror_window_linear_bwd(base, g, length, taps, tile):
    """(dvol [R, L], writes [R*L]) of the kernel's coefficient table and
    store order, in numpy fp32."""
    rows, span = base.shape[0], taps + 1
    dvol = np.full(rows * length, np.nan, np.float32)
    writes = np.zeros(rows * length, np.int64)
    one = np.float32(1)
    for r0 in range(0, rows, tile):
        nrows = min(tile, rows - r0)
        starts = np.zeros(nrows, np.int64)
        coeff = np.full(nrows * span, np.nan, np.float32)
        for i in range(nrows * span):
            row, j = divmod(i, span)
            b = base[r0 + row]
            f0 = np.floor(b)
            f = b - f0
            i0 = int(np.clip(f0, np.float32(-(taps + 1)), np.float32(length)))
            if j == 0:
                starts[row] = i0
            c = np.float32(0)
            if j < taps:
                c = (one - f) * g[r0 + row, j]
            if j >= 1:
                c = c + f * g[r0 + row, j - 1]
            coeff[i] = c

        def entry(row, l):
            j = l - starts[row]
            return coeff[row * span + j] if 0 <= j <= taps else np.float32(0)

        total, dst = nrows * length, r0 * length
        step_rows = 128 // length
        step_l = 128 - step_rows * length
        for lane in range(32):
            row, l = divmod(4 * lane, length)
            for v in range(lane, total // 4, 32):
                rr, ll = row, l
                for q in range(4):
                    dvol[dst + 4 * v + q] = entry(rr, ll)
                    writes[dst + 4 * v + q] += 1
                    ll += 1
                    if ll == length:
                        ll, rr = 0, rr + 1
                row, l = row + step_rows, l + step_l
                if l >= length:
                    l, row = l - length, row + 1
        for e in range(total & ~3, total):
            row = e // length
            dvol[dst + e] = entry(row, e - row * length)
            writes[dst + e] += 1
    return dvol.reshape(rows, length), writes


@pytest.mark.parametrize("rows,length,taps", [(70, 48, 9), (70, 39, 9), (45, 78, 9), (40, 312, 9),
                                              (70, 48, 1), (70, 39, 17), (33, 78, 17), (70, 3, 9)])
def test_window_linear_backward_tiles_match_plain(rows, length, taps):
    """The coefficient table and the tiled, vectorised store order, mirrored
    in numpy fp32 with tiles of 4, 16 and 32 rows (a ragged last tile at
    every height), write every entry once and equal the plain version bit
    for bit, far starts and windows that hang over either end included."""
    from anystereo_tpu_torch.ops.kernels.lookup_linear import gather_window_linear_bwd_ref

    rng = np.random.default_rng(rows * length + taps)
    base = rng.uniform(-taps - 3, length + 3, rows).astype(np.float32)
    base[:4] = np.array([-3e9, 3e9, -1e6, 1e6], np.float32)
    base[4], base[5] = np.float32(-1.0), np.float32(length - taps)
    g = rng.standard_normal((rows, taps)).astype(np.float32)
    want = gather_window_linear_bwd_ref(torch.from_numpy(base), torch.from_numpy(g), length, taps).numpy()
    for tile in (4, 16, 32):
        got, writes = _mirror_window_linear_bwd(base, g, length, taps, tile)
        assert (writes == 1).all()
        np.testing.assert_array_equal(got, want)
        assert not got[:4].any()


# ------------------------------------------------ the rows linear backward (B8)
#
# `csrc/lookup_linear.cu:rows_linear_bwd`: a block takes a range of at most
# ROWS_SPAN entries of one row (at most ROWS_THREADS where every chunk is
# walked; longer rows split into equal ranges) and
# the row's taps ROWS_CHUNK at a time.  A tap's bucket is b = i0 - e0 + 1
# (none if neither half lands in the range).  Each chunk of a row of more
# than ROWS_WALK taps is sorted: its groups of 32 taps are split into runs, one
# for each of the block's first min(8, groups) warps; each warp counts its
# taps by bucket; a scan over (bucket, warp) gives each warp its first slot
# in each bucket; each warp places its taps, a tap's rank in its group the
# number of lower lanes with its bucket (`__match_any_sync`); entry el
# merges bucket el (upper halves) and bucket el + 1 (lower halves) by k
# into its running sum, carried from chunk to chunk.  A row of at most
# ROWS_WALK taps is walked by each entry in ascending k.

ROWS_CHUNK, ROWS_SPAN, ROWS_WALK, ROWS_THREADS = 1280, 640, 32, 256
ROWS_WARPS = ROWS_THREADS // 32


def _mirror_rows_linear_bwd(pos, g, length, chunk=ROWS_CHUNK, max_span=ROWS_SPAN):
    """The kernel's walk, sort and merge in numpy fp32: dvol [R, L] (NaN
    where no range wrote)."""
    rows, taps = pos.shape
    widest = min(max_span, ROWS_THREADS) if taps <= ROWS_WALK else max_span  # walked: an entry a thread
    ranges = -(-length // widest)
    span = -(-length // ranges)
    dvol = np.full((rows, length), np.nan, np.float32)
    one = np.float32(1)
    for r in range(rows):
        for e0 in range(0, length, span):
            entries = min(span, length - e0)
            buckets = entries + 1
            acc = np.zeros(entries, np.float32)
            for k0 in range(0, taps, chunk):
                n = min(chunk, taps - k0)
                p, gv = pos[r, k0:k0 + n], g[r, k0:k0 + n]
                f0 = np.floor(p)
                w = p - f0
                b = np.clip(f0, np.float32(-2), np.float32(length)).astype(np.int64) - e0 + 1
                bucket = np.where((b >= 0) & (b <= entries), b, -1)
                lower, upper = gv * (one - w), gv * w
                if taps <= ROWS_WALK:  # one chunk
                    for el in range(entries):
                        for i in range(n):
                            if bucket[i] == el + 1:
                                acc[el] = acc[el] + lower[i]
                            elif bucket[i] == el:
                                acc[el] = acc[el] + upper[i]
                    continue
                groups = -(-n // 32)
                sorters = min(ROWS_WARPS, groups)
                per_warp = -(-groups // sorters)
                runs = [range(min(groups, v * per_warp), min(groups, v * per_warp + per_warp))
                        for v in range(sorters)]
                slot = np.zeros((sorters, buckets), np.int64)
                for v, run in enumerate(runs):
                    for i in (i for grp in run for i in range(grp * 32, min(n, grp * 32 + 32))):
                        if bucket[i] >= 0:
                            slot[v, bucket[i]] += 1
                start = np.zeros(buckets + 1, np.int64)
                nxt = 0
                for bk in range(buckets):
                    start[bk] = nxt
                    for v in range(sorters):
                        slot[v, bk], nxt = nxt, nxt + slot[v, bk]
                start[buckets] = nxt
                order = np.full(n, -1, np.int64)
                for v, run in enumerate(runs):
                    for grp in run:
                        lanes = [(lane, bucket[grp * 32 + lane]) for lane in range(32)
                                 if grp * 32 + lane < n and bucket[grp * 32 + lane] >= 0]
                        for lane, bk in lanes:
                            rank = sum(1 for other, ob in lanes if ob == bk and other < lane)
                            order[slot[v, bk] + rank] = grp * 32 + lane
                        for bk in {bk for _, bk in lanes}:
                            slot[v, bk] += sum(1 for _, ob in lanes if ob == bk)
                live = np.flatnonzero(bucket >= 0)
                # the placement is a permutation of the live taps, sorted by bucket
                assert sorted(order[:nxt]) == list(live) and (order[nxt:] == -1).all()
                assert (np.diff(bucket[order[:nxt]]) >= 0).all()
                for el in range(entries):
                    a, bi, mid, end = start[el], start[el + 1], start[el + 1], start[el + 2]
                    while a < mid or bi < end:
                        if bi == end or (a < mid and order[a] < order[bi]):
                            acc[el] = acc[el] + upper[order[a]]
                            a += 1
                        else:
                            acc[el] = acc[el] + lower[order[bi]]
                            bi += 1
            dvol[r, e0:e0 + entries] = acc
    return dvol


@pytest.mark.parametrize("rows,length,taps,chunk,max_span,positions", [
    (4, 40, 150, 64, ROWS_SPAN, "random"),   # K > chunk and K > L: three chunks, the last of 22
    (4, 40, 150, 64, 16, "random"),          # and ranges of 14 entries split each row
    (3, 45, 9, ROWS_CHUNK, 16, "random"),    # a short row split in three, its 9 taps walked
    (3, 600, 20, ROWS_CHUNK, ROWS_SPAN, "random"),  # walked: three ranges of 200, one entry a thread
    (3, 78, 2500, ROWS_CHUNK, ROWS_SPAN, "random"),  # the card test's K > L, two chunks
    (3, 1242, 1242, ROWS_CHUNK, ROWS_SPAN, "warp"),  # the occlusion warp's row: two ranges
    (3, 300, 600, 100, 128, "warp"),         # x - disparity, not monotone, across chunks and ranges
])
def test_rows_linear_backward_sort_matches_plain(rows, length, taps, chunk, max_span, positions):
    """The chunked stable bucket sort and the two-list merge, mirrored in
    numpy fp32, place every live tap once and equal the plain version bit
    for bit: a row with all its taps on one entry, i0 at -2, -1, L-1 and L,
    far positions (+-1e6, +-3e9) and non-monotone warp positions included."""
    from anystereo_tpu_torch.ops.kernels.lookup_linear import gather_rows_linear_bwd_ref

    rng = np.random.default_rng(rows * length + taps + chunk)
    if positions == "warp":  # x - disparity, as `warp_disparity` forms it
        disp = rng.uniform(0, 60, (rows, taps)).astype(np.float32)
        pos = (np.arange(taps, dtype=np.float32) * np.float32(length / taps) - disp).astype(np.float32)
        assert (np.diff(pos, axis=1) < 0).any()
    else:
        pos = rng.uniform(-4, length + 4, (rows, taps)).astype(np.float32)
    pos[0, :8] = np.array([-3e9, 3e9, -1e6, 1e6, -1.5, -0.5, length - 0.5, length + 0.25], np.float32)
    pos[1] = np.float32(2.25)  # every tap of the row on one entry
    g = rng.standard_normal((rows, taps)).astype(np.float32)
    got = _mirror_rows_linear_bwd(pos, g, length, chunk, max_span)
    want = gather_rows_linear_bwd_ref(torch.from_numpy(pos), torch.from_numpy(g), length).numpy()
    np.testing.assert_array_equal(got, want)


# --------------------------------------- the library column of B7 and B8

@pytest.mark.parametrize("rows,length,taps,window", [(500, 48, 9, True), (300, 312, 9, True),
                                                     (200, 39, 9, True), (40, 1242, 1242, False),
                                                     (300, 312, 9, False)])
def test_grid_sample_is_the_linear_lookups_library_call(rows, length, taps, window):
    """`chip_smoke.py` times `grid_sample` on the volume viewed as
    [R, 1, 1, L] (bilinear, zero padding, align_corners=True) and its
    backward in the volume as the one PyTorch call beside B7 and B8: on the
    CPU it agrees with their plain versions, forward and backward, within
    the tolerance it is held to on the card."""
    import chip_smoke
    from anystereo_tpu_torch.ops.kernels import lookup_linear as tl

    g = torch.Generator().manual_seed(rows + length)
    vol = torch.randn(rows, length, generator=g)
    cot = torch.randn(rows, taps, generator=g)
    if window:
        base = torch.rand(rows, generator=g) * (length + 18) - 13
        pos = base[:, None] + torch.arange(taps)
        want, dwant = tl.gather_window_linear_ref(vol, base, taps), \
            tl.gather_window_linear_bwd_ref(base, cot, length, taps)
    else:
        pos = torch.rand(rows, taps, generator=g) * (length + 8) - 4
        want, dwant = tl.gather_rows_linear_ref(vol, pos), tl.gather_rows_linear_bwd_ref(pos, cot, length)
    fwd, bwd = chip_smoke._library_linear(torch, vol, pos, cot)
    tol = chip_smoke._library_atol(length)
    torch.testing.assert_close(fwd(), want, rtol=0, atol=tol)
    torch.testing.assert_close(bwd(), dwant, rtol=0, atol=tol)


# ---------------------------------- B2's ordered (deterministic) backward

# `scatter_rows_ordered` in gather_rows.cu, mirrored: a block owns `rows`
# consecutive table rows of a sample.  The queries are cut into
# ORDERED_WARPS segments of a multiple of 32 indices, counted from the
# 16-byte word that holds the first (`off`: the sample's first index's
# place in its word), one a warp.  A warp reads its segment a word (4
# indices) a lane, in groups of 32 words; it counts its queries by (row,
# segment) and stages the first STAGE_CAP of them in ascending q, a lane's
# slot the hits of the lanes below it.  An exclusive scan over (row, then
# segment) gives each segment its first slot in each row's list; each warp
# places its staged queries 32 at a time, a query's rank the number of
# lower lanes with its row (`__match_any_sync`), then, where its segment
# found more, the rest one lane after another; each row sums its list in
# fp32 from zero.  Where the block's rows receive more than LIST_CAP
# queries, q goes in windows of LIST_CAP, the sums carried from window to
# window.

ORDERED_THREADS, ORDERED_ROWS_MIN, ORDERED_ROWS_MAX, ORDERED_BLOCKS = 512, 8, 128, 264
LIST_CAP, STAGE_CAP = 4096, 256
ORDERED_WARPS = ORDERED_THREADS // 32


def _ordered_rows(batch, n):
    """The launcher's rows a block (`ordered_rows` in the source)."""
    per_sample = max(ORDERED_BLOCKS // batch, 1)
    return min(max(-(-n // per_sample), ORDERED_ROWS_MIN), ORDERED_ROWS_MAX)


def _word_groups(rel, qa, qb, start, seg, off):
    """Segment `seg`'s groups of 32 words of [qa, qb) from query `start` on:
    for each, the 32 lanes' queries [32, 4] and rows (-1: none)."""
    lo, hi = (qa + off) & ~3, qb + off
    per_warp = -(-(hi - lo) // ORDERED_WARPS)
    per = -(-per_warp // 32) * 32
    s = min(lo + seg * per, hi)
    e = min(s + per, hi)
    for a0 in range(max(s, (start + off) & ~3), e, 128):
        a = a0 + np.arange(128).reshape(32, 4)
        j = a - off
        inside = (j >= start) & (a < e)
        yield j, np.where(inside, rel[np.clip(j, 0, len(rel) - 1)], -1)


def _mirror_scatter_rows_ordered(idx, g, n, rows_per_block, off=0, list_cap=LIST_CAP, stage_cap=STAGE_CAP):
    """The kernel's count, staging, scan, placement and windowed sums in
    numpy fp32: dtbl [B, n, C] (NaN where no block wrote).  Each placed
    list is checked against the stable sort's order of its row's queries."""
    batch, q, c = g.shape
    dtbl = np.full((batch, n, c), np.nan, np.float32)
    for b in range(batch):
        for p0 in range(0, n, rows_per_block):
            rows = min(rows_per_block, n - p0)
            rel = (idx[b].astype(np.int64) - p0) % 2 ** 32  # the kernel's unsigned compare
            rel[rel >= rows] = -1

            def count(qa, qb):
                cnt = np.zeros((rows, ORDERED_WARPS), np.int64)
                found, staged = [0] * ORDERED_WARPS, [[] for _ in range(ORDERED_WARPS)]
                for seg in range(ORDERED_WARPS):
                    for j, r in _word_groups(rel, qa, qb, qa, seg, off):
                        hits = (r >= 0).sum(axis=1)
                        for lane in range(32):
                            slot = found[seg] + hits[:lane].sum()
                            for k in np.flatnonzero(r[lane] >= 0):
                                cnt[r[lane, k], seg] += 1
                                if slot < stage_cap:
                                    staged[seg].append((j[lane, k], r[lane, k]))
                                slot += 1
                        found[seg] += hits.sum()
                slots = (np.cumsum(cnt) - cnt.reshape(-1)).reshape(rows, ORDERED_WARPS)
                return slots, np.append(slots[:, 0], cnt.sum()), found, staged

            slots, begin, found, staged = count(0, q)
            window = q if begin[rows] <= list_cap else list_cap
            acc = np.zeros((rows, c), np.float32)
            qa = 0
            while True:
                qb = q if q - qa <= window else qa + window
                if window != q:
                    slots, begin, found, staged = count(qa, qb)
                assert begin[rows] <= list_cap
                lst = np.full(begin[rows], -1, np.int64)
                for seg in range(ORDERED_WARPS):
                    for i0 in range(0, len(staged[seg]), 32):
                        group = staged[seg][i0:i0 + 32]
                        for lane, (j, r) in enumerate(group):
                            rank = sum(1 for _, other in group[:lane] if other == r)
                            lst[slots[r, seg] + rank] = j
                        for r in {r for _, r in group}:
                            slots[r, seg] += sum(1 for _, other in group if other == r)
                    if found[seg] > stage_cap:  # the rest, one lane after another
                        for j, r in _word_groups(rel, qa, qb, staged[seg][-1][0] + 1, seg, off):
                            for lane in range(32):
                                for k in np.flatnonzero(r[lane] >= 0):
                                    lst[slots[r[lane, k], seg]] = j[lane, k]
                                    slots[r[lane, k], seg] += 1
                for r in range(rows):
                    mine = lst[begin[r]:begin[r + 1]]
                    np.testing.assert_array_equal(mine, qa + np.flatnonzero(rel[qa:qb] == r))
                    for i in mine:
                        acc[r] = acc[r] + g[b, i]
                qa = qb
                if qa >= q:
                    break
            dtbl[b, p0:p0 + rows] = acc
    return dtbl


def test_ordered_scatter_constants_and_rows_match_the_source():
    """The mirror's constants are the kernel's; at the training tables the
    grid holds two blocks for each of the H100's 132 SMs or nearly: 25 rows
    a block at N 3,200 (256 blocks), 97 at N 12,800 (264)."""
    import re
    from pathlib import Path

    src = (Path(__file__).resolve().parents[1] / "anystereo_tpu_torch" / "csrc" / "gather_rows.cu").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    assert (const("kOrderedThreads"), const("kOrderedRowsMin"), const("kOrderedRowsMax"),
            const("kOrderedBlocks"), const("kListCap"), const("kStageCap")) == (
        ORDERED_THREADS, ORDERED_ROWS_MIN, ORDERED_ROWS_MAX, ORDERED_BLOCKS, LIST_CAP, STAGE_CAP)
    assert [_ordered_rows(2, n) for n in (3200, 12800, 300, 10 ** 6)] == [25, 97, 8, 128]
    assert [2 * -(-n // _ordered_rows(2, n)) for n in (3200, 12800)] == [256, 264]
    assert _ordered_rows(1, 300) == 8 and _ordered_rows(300, 3200) == 128


@pytest.mark.parametrize("batch,n,q,c,rows,off,list_cap,stage_cap,kind,dtype", [
    (2, 300, 5003, 9, 25, 0, LIST_CAP, STAGE_CAP, "random", torch.float32),  # n not a multiple of the rows
    (2, 300, 5003, 40, 64, 3, LIST_CAP, STAGE_CAP, "half", torch.bfloat16),  # half on one row: staging full
    (1, 300, 5003, 184, 32, 1, 1000, STAGE_CAP, "one", torch.bfloat16),      # every query on one row: windows
    (2, 100, 3000, 1, 128, 2, 256, 8, "random", torch.float32),              # one block of 100 rows, in windows
    (3, 77, 2000, 40, 32, 1, LIST_CAP, 4, "random", torch.bfloat16),         # three samples, small staging
    (1, 40, 700, 184, 128, 2, LIST_CAP, STAGE_CAP, "half", torch.float32),   # a segment shorter than a group
    (1, 40, 8192, 9, 8, 1, LIST_CAP, STAGE_CAP, "crowded", torch.float32),    # more than a warp stages
])
def test_ordered_scatter_places_and_sums_as_index_add(batch, n, q, c, rows, off, list_cap, stage_cap, kind,
                                                       dtype):
    """The ordered kernel's counts, staging, scan, match-any ranks, the
    lane-by-lane rest of a full staging and its windows, mirrored in numpy
    fp32, with the sample's first index at each place in its 16-byte word:
    each row's list is its queries in ascending q (the stable sort's), and
    the sums equal the plain version (`index_add_`) bit for bit; indices out
    of range are dropped."""
    from anystereo_tpu_torch.ops.kernels.gather import scatter_rows_add_ref

    rng = np.random.default_rng(batch * n + q + c)
    idx = rng.integers(0, n, (batch, q)).astype(np.int32)
    if kind == "half":
        idx[:, ::2] = 5
    elif kind == "one":
        idx[:] = 7
    elif kind == "crowded":  # the first half, LIST_CAP queries, on the first block's rows
        idx[:, :q // 2] = np.arange(q // 2) % rows
    idx[:, :4] = np.array([-1, n, n + 7, -(2 ** 31)], np.int32)
    g = torch.from_numpy(rng.standard_normal((batch, q, c)).astype(np.float32)).to(dtype)
    got = _mirror_scatter_rows_ordered(idx, g.float().numpy(), n, rows, off, list_cap, stage_cap)
    valid = torch.from_numpy((idx >= 0) & (idx < n))[..., None]
    want = scatter_rows_add_ref(torch.from_numpy(idx).clamp(0, n - 1), g * valid, n)
    np.testing.assert_array_equal(got, want.numpy())
