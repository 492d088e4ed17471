"""Layout helpers for reference PyTorch weights (a copy of the JAX
package's `utils/torch_compat.py`, numpy only).

They map the reference's tensors into the flax layout that the converter
(`utils/torch_convert.py`) builds and `utils/weights.from_flax` reads:

  torch Conv2d weight  [O, I, kh, kw]     → conv kernel [kh, kw, I, O]
  torch Conv3d weight  [O, I, kd, kh, kw] → [kd, kh, kw, I, O]
  torch ConvTranspose weight [I, O, *k]  → TorchConvTranspose kernel [*k, I, O]
  torch Linear weight  [O, I]             → Dense kernel [I, O]
  torch BatchNorm{2,3}d (weight, bias, running_mean, running_var)
      → FrozenBatchNorm (scale, bias) params + (mean, var) batch_stats
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def conv_kernel(w: np.ndarray) -> np.ndarray:
    """[O, I, *spatial] → [*spatial, I, O]."""
    nd = w.ndim
    return np.transpose(w, tuple(range(2, nd)) + (1, 0))


def conv_transpose_kernel(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose: [I, O, *spatial] → [*spatial, I, O]."""
    nd = w.ndim
    return np.transpose(w, tuple(range(2, nd)) + (0, 1))


def dense_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w)


def frozen_bn(prefix: str, sd: Dict[str, np.ndarray]):
    """(params, batch_stats) dicts of a FrozenBatchNorm from a torch
    BatchNorm's state_dict prefix."""
    params = {
        "scale": np.asarray(sd[f"{prefix}.weight"]),
        "bias": np.asarray(sd[f"{prefix}.bias"]),
    }
    stats = {
        "mean": np.asarray(sd[f"{prefix}.running_mean"]),
        "var": np.asarray(sd[f"{prefix}.running_var"]),
    }
    return params, stats


def strip_module_prefix(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop the `module.` prefix that checkpoints saved from a
    DataParallel-wrapped model carry."""
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in sd.items()
    }
