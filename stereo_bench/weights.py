"""Seeded weights for both sides: one state dict, drawn on the device in one
call, loaded into the program (`load_state_dict`, strict) and into the
reference alike."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

BIAS_STD = 0.05  # biases and norm shifts ~ N(0, 0.05^2)
SCALE_STD = 0.05  # norm scales ~ 1 + N(0, 0.05^2)


def make_state_dict(reference, shapes_from: torch.nn.Module, seed: int, device,
                    gains: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
    """fp32 parameters for every parameter of `shapes_from`, a model of the
    reference module `reference` (on any device, the meta device included),
    by the kind `reference.param_kinds` gives each: convolution and dense
    weights ~ N(0, 1 / fan_in) (lecun normal), biases and norm shifts
    ~ N(0, BIAS_STD^2), norm scales ~ 1 + N(0, SCALE_STD^2).  One normal
    draw of every parameter's count from a generator on `device` seeded
    with `seed`, cut into leaves in name order.  `gains` ({name prefix:
    factor}) scales the weights of the leaves under a prefix: a
    configuration's `weight_gain`, which keeps its iterations contractive,
    as a trained model's are."""
    kinds = reference.param_kinds(shapes_from)
    names = sorted(kinds)
    shapes = {n: tuple(p.shape) for n, p in shapes_from.named_parameters()}
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {}
    for name, z in zip(names, flat.split(sizes)):
        kind = kinds[name]
        z = z.view(shapes[name])
        if kind.startswith("fan_in"):
            gain = next((g for prefix, g in (gains or {}).items() if name.startswith(prefix)), 1.0)
            out[name] = z * (gain / math.sqrt(reference.fan_in(shapes[name], kind)))
        elif kind == "bias":
            out[name] = z * BIAS_STD
        else:
            out[name] = 1.0 + z * SCALE_STD
    return out
