"""Divisibility padding for inference (twin of `anystereo_tpu/eval/padder.py`)."""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F


class InputPadder:
    """Pads [B, H, W, C] images so H and W are divisible by `divis_by`.

    mode "sintel": the padding is split evenly top/bottom and left/right;
    otherwise all height padding goes to the bottom.  The fill replicates
    the edge."""

    def __init__(self, dims: Tuple[int, ...], mode: str = "sintel", divis_by: int = 8):
        self.ht, self.wd = dims[-3:-1] if len(dims) == 4 else dims[-2:]
        pad_ht = (((self.ht // divis_by) + 1) * divis_by - self.ht) % divis_by
        pad_wd = (((self.wd // divis_by) + 1) * divis_by - self.wd) % divis_by
        if mode == "sintel":
            # [left, right, top, bottom]
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    def pad(self, *inputs: torch.Tensor) -> List[torch.Tensor]:
        return [F.pad(x.permute(0, 3, 1, 2), self._pad, mode="replicate").permute(0, 2, 3, 1)
                for x in inputs]

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, ...] or [B, H, W]."""
        l, r, t, b = self._pad
        h, w = x.shape[1], x.shape[2]
        return x[:, t : h - b, l : w - r]

    def get_pad_num(self) -> List[int]:
        """[top, bottom, left, right]."""
        l, r, t, b = self._pad
        return [t, b, l, r]

    @property
    def padded_shape(self) -> Tuple[int, int]:
        l, r, t, b = self._pad
        return self.ht + t + b, self.wd + l + r
