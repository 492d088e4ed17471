"""High-frequency stem branches producing the 1/2- and 1/4-resolution
latents (twin of `anystereo_tpu/nn/stems.py`; type3/4/5 stems)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from anystereo_tpu_torch.config import AggregationType, NormType
from anystereo_tpu_torch.nn.layers import (
    Conv, ConvNormAct, FlaxNamed, LayerNorm2d, make_norm, pixel_unshuffle,
)


class HighResAggregation(FlaxNamed):
    """PixelUnshuffle(2) embed → squeeze-excite gate (global average pool +
    1x1 conv, multiplied back) → 3x3 head with the variant's norm and
    activation.  type3: IN + ReLU; type4: LayerNorm2d + ReLU; type5:
    LayerNorm2d + GELU."""

    def __init__(self, in_ch: int, features: int, head_norm: str = "layer",
                 head_act: str = "gelu", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.head_act = head_act
        embed = self.add(ConvNormAct(4 * in_ch, features, 3, stride=1, padding=1,
                                     norm=NormType.INSTANCE, act="leaky", dtype=dtype))
        gate = self.add(Conv(features, features, 1, bias=True, dtype=dtype))
        conv = self.add(Conv(features, features, 3, 1, 1, bias=False, dtype=dtype))
        norm = self.add(LayerNorm2d(features) if head_norm == "layer"
                        else make_norm(NormType.INSTANCE, features, dtype))
        self.parts = (embed, gate, conv, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        embed, gate, conv, norm = self.parts
        y = embed(pixel_unshuffle(x, 2))
        y = y * gate(y.mean(dim=(2, 3), keepdim=True))
        y = norm(conv(y))
        return F.gelu(y, approximate="none") if self.head_act == "gelu" else F.relu(y)


class StemBranch(FlaxNamed):
    """The stem stack for one image: (stem_1x, stem_2x, stem_4x); stem_1x
    is None for every type ported so far."""

    def __init__(self, agg_type: AggregationType, dtype: Optional[torch.dtype] = None):
        super().__init__()
        t = agg_type
        if t not in (AggregationType.TYPE3, AggregationType.TYPE4, AggregationType.TYPE5):
            raise NotImplementedError(f"agg_type {t.value} is not ported yet")
        head_norm = "instance" if t is AggregationType.TYPE3 else "layer"
        head_act = "gelu" if t is AggregationType.TYPE5 else "relu"
        self.parts = (
            self.add(HighResAggregation(3, 32, head_norm, head_act, dtype), "stem_2"),
            self.add(HighResAggregation(32, 48, head_norm, head_act, dtype), "stem_4"),
        )

    def forward(self, x: torch.Tensor):
        stem_2, stem_4 = self.parts
        s2 = stem_2(x)
        return None, s2, stem_4(s2)
