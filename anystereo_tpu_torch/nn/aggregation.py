"""3-D cost-volume aggregation (twin of `anystereo_tpu/nn/aggregation.py`):
corr stem, image-feature attention and the 3-level hourglass producing the
geometry encoding volume.  Volumes are [B, C, D, H, W] here."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from anystereo_tpu_torch.config import NormType
from anystereo_tpu_torch.nn.layers import Conv, ConvNormAct, FlaxNamed


class FeatureAtt(FlaxNamed):
    """Image features → 1x1 convs → sigmoid gate on the volume, broadcast
    over the disparity axis."""

    def __init__(self, cv_channels: int, feat_channels: int, norm: NormType = NormType.GROUP,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        half = feat_channels // 2
        self.parts = (
            self.add(ConvNormAct(feat_channels, half, 1, stride=1, padding=0, norm=norm,
                                 act="leaky", dtype=dtype)),
            self.add(Conv(half, cv_channels, 1, dtype=dtype)),
        )

    def forward(self, volume: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        c1, c2 = self.parts
        return torch.sigmoid(c2(c1(feat))).unsqueeze(2) * volume


class _Conv3dBlock(FlaxNamed):
    """conv3d (or k4 s2 p1 transposed conv3d) → norm → LeakyReLU."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, transpose: bool = False,
                 norm: NormType = NormType.INSTANCE, act: Optional[str] = "leaky",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.parts = (self.add(ConvNormAct(
            in_ch, features, kernel if not transpose else 4, stride=stride,
            padding=padding, norm=norm, act=act, transpose=transpose, dims=3,
            dtype=dtype)),)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.parts[0](x)


class CostAggregation(FlaxNamed):
    """corr_stem → feature attention → hourglass → GEV [B, 8, D, H, W].

    feat_channels: channels of the image features at 1/4, 1/8, 1/16, 1/32
    (the 1/4 map carries the 48 stem channels beside the pyramid's 48)."""

    def __init__(self, in_channels: int = 8, norm: NormType = NormType.INSTANCE,
                 norm_2d: NormType = NormType.GROUP, dtype: Optional[torch.dtype] = None,
                 feat_channels: Sequence[int] = (96, 64, 192, 160)):
        super().__init__()
        c = in_channels
        f4, f8, f16, f32 = feat_channels

        def blk(i, o, **kw):
            return self.add(_Conv3dBlock(i, o, norm=norm, dtype=dtype, **kw))

        def att(cv, fc):
            return self.add(FeatureAtt(cv, fc, norm=norm_2d, dtype=dtype))

        stem = (blk(c, c), att(c, f4))
        down1 = (blk(c, 2 * c, stride=2), blk(2 * c, 2 * c), att(2 * c, f8))
        down2 = (blk(2 * c, 4 * c, stride=2), blk(4 * c, 4 * c), att(4 * c, f16))
        down3 = (blk(4 * c, 6 * c, stride=2), blk(6 * c, 6 * c), att(6 * c, f32))
        up2 = (blk(6 * c, 4 * c, stride=2, transpose=True),
               blk(8 * c, 4 * c, kernel=1, padding=0), blk(4 * c, 4 * c), blk(4 * c, 4 * c),
               att(4 * c, f16))
        up1 = (blk(4 * c, 2 * c, stride=2, transpose=True),
               blk(4 * c, 2 * c, kernel=1, padding=0), blk(2 * c, 2 * c), blk(2 * c, 2 * c),
               att(2 * c, f8))
        out = self.add(_Conv3dBlock(2 * c, 8, stride=2, transpose=True,
                                    norm=NormType.NONE, act=None, dtype=dtype))
        self.parts = (stem, down1, down2, down3, up2, up1, out)

    def forward(self, volume: torch.Tensor, features: List[torch.Tensor]) -> torch.Tensor:
        stem, down1, down2, down3, up2, up1, out = self.parts
        volume = stem[1](stem[0](volume), features[0])
        d1 = down1[2](down1[1](down1[0](volume)), features[1])
        d2 = down2[2](down2[1](down2[0](d1)), features[2])
        d3 = down3[2](down3[1](down3[0](d2)), features[3])
        u2 = torch.cat([up2[0](d3), d2], dim=1)
        u2 = up2[4](up2[3](up2[2](up2[1](u2))), features[2])
        u1 = torch.cat([up1[0](u2), d1], dim=1)
        u1 = up1[4](up1[3](up1[2](up1[1](u1))), features[1])
        return out(u1)
