"""LIIF implicit decoder, dense eval decode (twin of the dense path of
`anystereo_tpu/nn/liif.py`): per-pixel MLP weights that combine a 3x3
neighborhood of the low-res disparity at the output grid.

Ported: the ISU feature augmentation (every `IsuMode`), `Mlp`, the cell
input, and the dense separable decode with nearest sampling.  The query
path, positional encoders, local ensemble and 4-nearest modes raise
NotImplementedError.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from anystereo_tpu_torch.config import IsuMode, LiifConfig, PosEncType
from anystereo_tpu_torch.nn.layers import Dense, FlaxNamed
from anystereo_tpu_torch.ops.sampling import nearest_dense_gather


def affinity_features(
    feat: torch.Tensor, win: Tuple[int, int] = (3, 3), dilation: int = 1
) -> torch.Tensor:
    """Cosine of each pixel with its win_h*win_w - 1 neighbors at the given
    dilation, clamped at 0.  feat: [B,H,W,C] → [B,H,W,win_h*win_w-1]."""
    wh, ww = win
    norm = torch.sqrt((feat * feat).sum(dim=-1, keepdim=True))
    fn = feat / norm.clamp_min(1e-12)
    _, h, w, _ = feat.shape
    py, px = dilation * (wh // 2), dilation * (ww // 2)
    padded = F.pad(fn, (0, 0, px, px, py, py))
    outs = []
    for ky in range(wh):
        for kx in range(ww):
            if ky == wh // 2 and kx == ww // 2:
                continue
            oy, ox = ky * dilation, kx * dilation
            outs.append((fn * padded[:, oy:oy + h, ox:ox + w]).sum(dim=-1))
    return torch.stack(outs, dim=-1).clamp_min(0.0)


def structure_feature(x: torch.Tensor, cfg: LiifConfig) -> torch.Tensor:
    """ISU feature augmentation of one latent [B,H,W,C]."""
    mode, win, dil = cfg.isu_mode, cfg.isu_window, cfg.isu_dilations
    if mode is IsuMode.NONE:
        return x
    if mode is IsuMode.WITH_ISU:
        return torch.cat([x, affinity_features(x, win, dil[0])], dim=-1)
    if mode is IsuMode.WITH_V2_ISU:
        return torch.cat([x, affinity_features(x.detach(), win, dil[0])], dim=-1)
    if mode is IsuMode.ONLY_ISU:
        return affinity_features(x, win, dil[0])
    if mode is IsuMode.WITH_3V2_ISU:
        f = x.detach()
        return torch.cat([x] + [affinity_features(f, win, d) for d in dil[:3]], dim=-1)
    raise ValueError(mode)


def isu_extra_channels(cfg: LiifConfig) -> int:
    in_c = cfg.isu_window[0] * cfg.isu_window[1] - 1
    if cfg.isu_mode is IsuMode.NONE:
        return 0
    if cfg.isu_mode is IsuMode.WITH_3V2_ISU:
        return 3 * in_c
    return in_c


class Mlp(FlaxNamed):
    """Dense + ReLU stack."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dims = [in_dim, *hidden, out_dim]
        self.parts = tuple(self.add(Dense(a, b, dtype)) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.parts[:-1]:
            x = F.relu(layer(x))
        return self.parts[-1](x)


class LiifDecoder(FlaxNamed):
    """Dense decode: `feats` [B,h_i,w_i,C_i] at the axis grids ys [H'],
    xs [W'] → per-pixel tap logits [B, H', W', taps] (softmax is the
    caller's)."""

    def __init__(self, cfg: LiifConfig, channels: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        posenc = not (cfg.pos_enc is PosEncType.NONE
                      or (cfg.pos_enc is PosEncType.SPATIAL and cfg.pos_dim == 0))
        if posenc or cfg.local_ensemble or cfg.quarter_nearest != "none":
            raise NotImplementedError(
                "positional encoders, local ensemble and quarter_nearest decoding "
                "are not ported yet")
        self.cfg = cfg
        extra = isu_extra_channels(cfg)
        dim = sum((extra if cfg.isu_mode is IsuMode.ONLY_ISU else c + extra) for c in channels)
        dim += (2 + (2 if cfg.decode_cell else 0)) * len(channels)
        self.imnet = Mlp(dim, cfg.mlp_hidden, cfg.taps, dtype)

    def forward(self, feats: List[torch.Tensor], ys: torch.Tensor, xs: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
        feats = [structure_feature(f, self.cfg) for f in feats]
        return self.imnet(self._build_latent_dense(feats, ys, xs, scale))

    def _build_latent_dense(self, feats, ys, xs, scale):
        """Latent [B, H', W', C]: per feat, the nearest latent pixel and the
        query's offset from that pixel's center in latent-pixel units."""
        oh, ow = ys.shape[0], xs.shape[0]
        b = feats[0].shape[0]
        pieces = []
        for feat in feats:
            fh, fw = feat.shape[1], feat.shape[2]
            q_feat, iy, ix = nearest_dense_gather(feat, ys, xs)
            qc_y = -1.0 + (2.0 * iy + 1.0) / fh
            qc_x = -1.0 + (2.0 * ix + 1.0) / fw
            rel_y = (ys - qc_y) * fh
            rel_x = (xs - qc_x) * fw
            rel = torch.stack([rel_y[:, None].expand(oh, ow), rel_x[None, :].expand(oh, ow)], dim=-1)
            piece = [q_feat, rel.to(q_feat.dtype).expand(b, oh, ow, 2)]
            if self.cfg.decode_cell:
                cell = (2.0 / scale).reshape(b, 1, 1, 1).expand(b, oh, ow, 2)
                piece.append(cell.to(q_feat.dtype))
            pieces.append(torch.cat(piece, dim=-1))
        return torch.cat(pieces, dim=-1)
