"""Weight bridge: the JAX package's flax variables → a torch state_dict.

The port's modules name their children the way flax's compact auto-naming
names the JAX modules (`Conv_0`, `GroupNorm_1`, `ResidualBlock_3`, ...), so a
flax path `params/feature/MobileNetV2Trunk_0/Conv_0/kernel` becomes the
torch key `feature.MobileNetV2Trunk_0.Conv_0.weight`.  Only the leaves
change layout:

  conv kernel            [kh, kw, I, O]      → weight [O, I, kh, kw]
  conv3d kernel          [kd, kh, kw, I, O]  → weight [O, I, kd, kh, kw]
  Dense kernel           [I, O]              → weight [O, I]
  TorchConvTranspose     [*k, I, O]          → weight [I, O, *k]
  GroupNorm / LayerNorm2d / FrozenBatchNorm scale → weight, bias → bias
  FrozenBatchNorm batch_stats mean / var   → buffers running_mean / running_var

This is the inverse of the torch→flax converters of the JAX package.

A gradient tree has the parameter tree's shape and every layout change
above is a permutation of entries, so `from_flax({"params": grads})` carries
JAX gradients across as well: each comes out in the layout of the `.grad`
of the parameter with the same key.  No leaf needs other treatment as a
gradient.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _convert_param(path: Tuple[str, ...], value: np.ndarray) -> Tuple[str, np.ndarray]:
    leaf = path[-1]
    if leaf == "kernel":
        nd = value.ndim
        if len(path) > 1 and path[-2].startswith("TorchConvTranspose"):
            return "weight", np.transpose(value, (nd - 2, nd - 1) + tuple(range(nd - 2)))
        if nd == 2:  # Dense
            return "weight", value.T
        return "weight", np.transpose(value, (nd - 1, nd - 2) + tuple(range(nd - 2)))
    if leaf == "scale":
        return "weight", value
    return leaf, value


def from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """`variables`: the flax `{"params": ..., "batch_stats": ...}` tree with
    numpy (or array-protocol) leaves.  Returns a state_dict of fp32 tensors
    for the port's module of the same structure."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(variables.get("params", {})):
        name, arr = _convert_param(path, np.asarray(value, np.float32))
        sd[".".join(path[:-1] + (name,))] = torch.from_numpy(np.array(arr, np.float32, copy=True))
    for path, value in _leaves(variables.get("batch_stats", {})):
        name = _STAT_NAMES[path[-1]]
        arr = np.asarray(value, np.float32)
        sd[".".join(path[:-1] + (name,))] = torch.from_numpy(np.array(arr, np.float32, copy=True))
    return sd
