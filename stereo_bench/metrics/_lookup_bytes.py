"""The least bytes the aligned pyramid lookup (the program's
`ops/kernels/lookup.py` over `csrc/lookup_aligned.cu`) must move, from the
positions and shapes of a call.  Not a metric: the lookup rooflines read it.

Forward, one call: `vol [R, L]` fp32 rows, positions `x [R]` fp32, output
`[R, levels * taps]` in the compute dtype.  Level l reads the row averaged
in runs of 2^l entries, at taps x / 2^l - r + k (k = 0 .. taps - 1), each
tap interpolating between pooled cells i and i + 1: the taps + 1 cells from
floor(x / 2^l - r) on, clipped to the L >> l cells of the pooled row.  A
pooled cell is 2^l entries of the row, so the entries read are the union
over the levels of those cells' entries.  Each such entry is read once (4
bytes), each x once (4), the output written once:

    bytes = 4 * sum_rows |union_l window_l| + 4 R + itemsize * R * levels * taps

Positions are clamped as the kernel clamps them, to within
(r + 2) * 2^levels of the row: past that every tap is zero at every level.

These are the counts of the "bound" column of the kernel table in PERF.md
(the program's `chip_smoke.py`, `_lookup_cost`).
"""

from __future__ import annotations

import torch


def window_entries(x: torch.Tensor, length: int, levels: int, taps: int) -> int:
    """Entries of the rows of length `length` that some level's window
    covers, summed over the rows, for positions x [R]."""
    r = (taps - 1) // 2
    slack = (r + 2) * 2 ** levels
    xc = x.float().clamp(-slack, length + slack)
    j = torch.arange(length, device=x.device)
    total = 0
    for rows in xc.split(1 << 16):
        need = torch.zeros((rows.shape[0], length), dtype=torch.bool, device=x.device)
        for lvl in range(levels):
            width, n = 2 ** lvl, length >> lvl
            start = torch.floor(rows / width - r).long()
            lo = start.clamp(0, n) * width
            hi = (start + taps + 1).clamp(0, n) * width
            need |= (j >= lo[:, None]) & (j < hi[:, None])
        total += int(need.sum())
    return total


def forward_bytes(x: torch.Tensor, length: int, levels: int, taps: int, out_itemsize: int,
                  repeat: int = 1) -> int:
    """One forward call whose rows come in runs of `repeat` with one
    position each (the GEV volume: a position a pixel, `repeat` = groups)."""
    rows = x.numel() * repeat
    return 4 * repeat * window_entries(x, length, levels, taps) + 4 * rows + out_itemsize * rows * levels * taps

