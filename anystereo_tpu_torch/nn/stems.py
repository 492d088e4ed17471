"""High-frequency stem branches producing the 1/2- and 1/4-resolution
latents (twin of `anystereo_tpu/nn/stems.py`)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from anystereo_tpu_torch.config import AggregationType, NormType
from anystereo_tpu_torch.nn.layers import (
    Conv, ConvNormAct, FlaxNamed, LayerNorm2d, instance_norm, make_norm, pixel_unshuffle,
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


class ConvStem(FlaxNamed):
    """The conv stems: [PixelUnshuffle(2)] → conv + IN + LeakyReLU (stride
    `stride`) → 3x3 conv + IN + ReLU.  type1/type2 (`UnshuffleStem` in the
    JAX package): unshuffle, stride 1; type2's full-resolution stem_1: no
    unshuffle, stride 1; the RAFT-only "IGEV" stems (`IgevStem`): no
    unshuffle, stride 2."""

    def __init__(self, in_ch: int, features: int, unshuffle: bool = True, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.unshuffle = unshuffle
        self.parts = (
            self.add(ConvNormAct((4 if unshuffle else 1) * in_ch, features, 3, stride=stride,
                                 padding=1, norm=NormType.INSTANCE, act="leaky", dtype=dtype)),
            self.add(Conv(features, features, 3, 1, 1, bias=False, dtype=dtype)),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        embed, conv = self.parts
        if self.unshuffle:
            x = pixel_unshuffle(x, 2)
        return F.relu(instance_norm(conv(embed(x))))


class StemBranch(FlaxNamed):
    """The stem stack for one image: (stem_1x, stem_2x, stem_4x); stem_1x
    is None except for type2, and "none" (RAFT core only) has no stems."""

    def __init__(self, agg_type: AggregationType, dtype: Optional[torch.dtype] = None):
        super().__init__()
        t = agg_type
        stems = {}
        if t is AggregationType.NONE:
            pass
        elif t is AggregationType.IGEV:
            stems["stem_2"] = ConvStem(3, 32, unshuffle=False, stride=2, dtype=dtype)
            stems["stem_4"] = ConvStem(32, 48, unshuffle=False, stride=2, dtype=dtype)
        elif t in (AggregationType.TYPE1, AggregationType.TYPE2):
            first = 3
            if t is AggregationType.TYPE2:
                stems["stem_1"] = ConvStem(3, 8, unshuffle=False, dtype=dtype)
                first = 8
            stems["stem_2"] = ConvStem(first, 32, dtype=dtype)
            stems["stem_4"] = ConvStem(32, 48, dtype=dtype)
        else:
            head_norm = "instance" if t is AggregationType.TYPE3 else "layer"
            head_act = "gelu" if t is AggregationType.TYPE5 else "relu"
            stems["stem_2"] = HighResAggregation(3, 32, head_norm, head_act, dtype)
            stems["stem_4"] = HighResAggregation(32, 48, head_norm, head_act, dtype)
        for name, module in stems.items():
            self.add(module, name)
        self.parts = tuple(stems.get(n) for n in ("stem_1", "stem_2", "stem_4"))

    def forward(self, x: torch.Tensor):
        stem_1, stem_2, stem_4 = self.parts
        if stem_2 is None:
            return None, None, None
        s1 = None if stem_1 is None else stem_1(x)
        s2 = stem_2(x if s1 is None else s1)
        return s1, s2, stem_4(s2)


def stem_channels(agg_type: AggregationType) -> Tuple[int, ...]:
    """Channel counts of the stems that feed the LIIF decoder, in the
    decoder's input order."""
    if agg_type is AggregationType.NONE:
        return ()
    if agg_type is AggregationType.TYPE2:
        return (8, 32, 48)
    return (32, 48)
