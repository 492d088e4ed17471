"""Feature extraction (twin of `anystereo_tpu/nn/extractor.py`): the
MobileNetV2 matching pyramid (IGEV core), the RAFT matching encoder and the
multi-scale context encoder.
Channels-first inside; child names follow the flax twin's."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from anystereo_tpu_torch.config import NormType
from anystereo_tpu_torch.nn.layers import Conv, Conv2x, ConvNormAct, FlaxNamed, make_norm


def _relu6(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0.0, 6.0)


class InvertedResidual(FlaxNamed):
    """1x1 expand → 3x3 depthwise → 1x1 project, residual when stride 1 and
    channels match."""

    def __init__(self, in_ch: int, features: int, stride: int = 1, expand: int = 6,
                 norm: NormType = NormType.GROUP, dtype: Optional[torch.dtype] = None):
        super().__init__()
        mid = in_ch * expand
        self.residual = stride == 1 and in_ch == features
        layers = []
        if expand != 1:
            layers += [self.add(Conv(in_ch, mid, 1, bias=False, dtype=dtype)),
                       self.add(make_norm(norm, mid, dtype)), _relu6]
        layers += [self.add(Conv(mid, mid, 3, stride, 1, groups=mid, bias=False, dtype=dtype)),
                   self.add(make_norm(norm, mid, dtype)), _relu6,
                   self.add(Conv(mid, features, 1, bias=False, dtype=dtype)),
                   self.add(make_norm(norm, features, dtype))]
        self.parts = tuple(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for f in self.parts:
            y = f(y)
        return y + x if self.residual else y


# (expansion, channels, repeats, first-stride) of mobilenetv2_100 blocks 0..5
_MBV2_STAGES = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
)


class MobileNetV2Trunk(FlaxNamed):
    """Returns (x2, x4, x8, x16, x32) with channels (16, 24, 32, 96, 160)."""

    def __init__(self, norm: NormType = NormType.GROUP, dtype: Optional[torch.dtype] = None):
        super().__init__()
        stem = (self.add(Conv(3, 32, 3, 2, 1, bias=False, dtype=dtype)),
                self.add(make_norm(norm, 32, dtype)))
        stages, in_ch = [], 32
        for t, c, n, s in _MBV2_STAGES:
            blocks = []
            for bi in range(n):
                blocks.append(self.add(InvertedResidual(
                    in_ch, c, s if bi == 0 else 1, t, norm, dtype)))
                in_ch = c
            stages.append(tuple(blocks))
        self.parts = (stem, tuple(stages))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        (conv, norm), stages = self.parts
        y = _relu6(norm(conv(x)))
        taps = []
        for blocks in stages:
            for blk in blocks:
                y = blk(y)
            taps.append(y)
        return taps[0], taps[1], taps[2], taps[4], taps[5]


class FeaturePyramid(FlaxNamed):
    """Trunk + top-down Conv2x fusion → [f4 (48ch, 1/4), f8 (64, 1/8),
    f16 (192, 1/16), f32 (160, 1/32)]."""

    def __init__(self, norm: NormType = NormType.GROUP, dtype: Optional[torch.dtype] = None):
        super().__init__()
        inst = NormType.INSTANCE
        self.parts = (
            self.add(MobileNetV2Trunk(norm, dtype)),
            self.add(Conv2x(160, 96, 96, deconv=True, norm=inst, dtype=dtype)),
            self.add(Conv2x(192, 32, 32, deconv=True, norm=inst, dtype=dtype)),
            self.add(Conv2x(64, 24, 24, deconv=True, norm=inst, dtype=dtype)),
            self.add(ConvNormAct(48, 48, 3, stride=1, padding=1, norm=inst, dtype=dtype)),
        )

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        trunk, up16, up8, up4, head = self.parts
        x2, x4, x8, x16, x32 = trunk(x)
        f16 = up16(x32, x16)
        f8 = up8(f16, x8)
        f4 = head(up4(f8, x4))
        return [f4, f8, f16, x32]


class ResidualBlock(FlaxNamed):
    """Two 3x3 convs + skip (1x1 projection when the shape changes)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 norm: NormType = NormType.GROUP, dtype: Optional[torch.dtype] = None):
        super().__init__()
        body = (self.add(Conv(in_ch, features, 3, stride, 1, dtype=dtype)),
                self.add(make_norm(norm, features, dtype)),
                self.add(Conv(features, features, 3, 1, 1, dtype=dtype)),
                self.add(make_norm(norm, features, dtype)))
        proj = ()
        if stride != 1 or in_ch != features:
            proj = (self.add(Conv(in_ch, features, 1, stride, dtype=dtype)),
                    self.add(make_norm(norm, features, dtype)))
        self.parts = (body, proj)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (c1, n1, c2, n2), proj = self.parts
        y = F.relu(n2(c2(F.relu(n1(c1(x))))))
        for f in proj:
            x = f(x)
        return F.relu(x + y)


def _stage_plan(downsample: int):
    """(channels, first-block stride) of the three residual stages shared by
    the RAFT and context encoders, and the stem conv's stride."""
    return 1 + (downsample > 2), ((64, 1), (96, 1 + (downsample > 1)), (128, 1 + (downsample > 0)))


class BasicEncoder(FlaxNamed):
    """RAFT matching encoder: 7x7 stem, three residual stages, 1x1 head;
    instance norm; the strides follow `downsample` (2 → output at 1/4)."""

    def __init__(self, output_dim: int = 256, downsample: int = 2,
                 norm: NormType = NormType.INSTANCE, dtype: Optional[torch.dtype] = None):
        super().__init__()
        s1, stages = _stage_plan(downsample)
        stem = (self.add(Conv(3, 64, 7, s1, 3, dtype=dtype)), self.add(make_norm(norm, 64, dtype)))
        blocks, in_ch = [], 64
        for ch, s in stages:
            blocks.append(self.add(ResidualBlock(in_ch, ch, s, norm, dtype)))
            blocks.append(self.add(ResidualBlock(ch, ch, 1, norm, dtype)))
            in_ch = ch
        self.parts = (stem, tuple(blocks), self.add(Conv(128, output_dim, 1, dtype=dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (conv, norm), blocks, head = self.parts
        y = F.relu(norm(conv(x)))
        for blk in blocks:
            y = blk(y)
        return head(y)


class MultiBasicEncoder(FlaxNamed):
    """Context encoder: [(net, inp)] per GRU level, ordered [1/4, 1/8,
    1/16][:n_layers]."""

    def __init__(self, hidden_dims: Sequence[int] = (128, 128, 128),
                 context_dims: Sequence[int] = (128, 128, 128), n_layers: int = 3,
                 downsample: int = 2, norm: NormType = NormType.GROUP,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        s1, stages = _stage_plan(downsample)
        stem = [self.add(Conv(3, 64, 7, s1, 3, dtype=dtype)), self.add(make_norm(norm, 64, dtype))]
        in_ch = 64
        for ch, s in stages:
            stem.append(self.add(ResidualBlock(in_ch, ch, s, norm, dtype)))
            stem.append(self.add(ResidualBlock(ch, ch, 1, norm, dtype)))
            in_ch = ch

        def head(dim, with_res, name):
            res = (self.add(ResidualBlock(128, 128, 1, norm, dtype), f"{name}_res"),) if with_res else ()
            return res + (self.add(Conv(128, dim, 3, 1, 1, dtype=dtype), f"{name}_conv"),)

        levels = [(head(hidden_dims[2], True, "net04"), head(context_dims[2], True, "inp04"), ())]
        if n_layers >= 2:
            down = (self.add(ResidualBlock(128, 128, 2, norm, dtype)),
                    self.add(ResidualBlock(128, 128, 1, norm, dtype)))
            levels.append((head(hidden_dims[1], True, "net08"),
                           head(context_dims[1], True, "inp08"), down))
        if n_layers == 3:
            down = (self.add(ResidualBlock(128, 128, 2, norm, dtype)),
                    self.add(ResidualBlock(128, 128, 1, norm, dtype)))
            levels.append((head(hidden_dims[0], False, "net16"),
                           head(context_dims[0], False, "inp16"), down))
        self.parts = (tuple(stem), tuple(levels))

    def forward(self, x: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        stem, levels = self.parts
        y = F.relu(stem[1](stem[0](x)))
        for blk in stem[2:]:
            y = blk(y)
        out = []
        for net_head, inp_head, down in levels:
            for blk in down:
                y = blk(y)
            n, i = y, y
            for f in net_head:
                n = f(n)
            for f in inp_head:
                i = f(i)
            out.append((n, i))
        return out
