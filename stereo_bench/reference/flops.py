"""FLOPs of a tick, counted once on the reference (the configuration's
reference module, `reference`) at the cell's shapes on the `meta` device,
which costs no memory and no time: the convolutions, transposed
convolutions and matrix products `torch.utils.flop_counter` counts, a
multiply-add as two.  The count does not depend on how the program
computes the step, so a kernel that takes work off PyTorch's books leaves
it unchanged."""

from __future__ import annotations

import torch


def _count(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def eval_flops(reference, model: dict, batch: int, h: int, w: int, iters: int, queries=None) -> float:
    """One eval forward of `batch` pairs of h x w, decoded densely, or at
    `queries` points a pair."""
    with torch.device("meta"):
        ref = reference.build(model)
        left, right = torch.empty(batch, h, w, 3), torch.empty(batch, h, w, 3)
        scale = torch.ones(batch)
        coords = None if queries is None else torch.zeros(batch, queries, 2)
    with torch.no_grad():
        return _count(lambda: ref(left, right, iters, scale, coords=coords))
