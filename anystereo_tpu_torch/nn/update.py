"""Iterative refinement (twin of `anystereo_tpu/nn/update.py`): motion
encoder, multi-level coupled ConvGRUs and the disparity head.

The JAX package's schedule rewrites (fused z/r gates, the joint q-conv,
the block-diagonal motion convs, the shift-matmul disparity head) keep the
parameter tree of the plain convs; the port computes the plain convs.

Layout: the maps keep [B, C, H, W] shapes and lie channels-last in memory
(`torch.channels_last`), as do the block's conv weights, so cuDNN's NHWC
convolutions read and write them with no transpose, and the gate math, the
concatenations along C and the [B, H, W, C] ops (pooling, resize, the
lookup's features) see contiguous tensors.  The caller hands in
channels-last hidden states and gate biases (`AnyStereo._context`) and a
channels-last disparity.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from anystereo_tpu_torch.nn.layers import Conv, nchw, nhwc
from anystereo_tpu_torch.ops.sampling import avg_pool2d, interp_bilinear


def _conv3(in_ch: int, features: int, dtype) -> Conv:
    return Conv(in_ch, features, 3, 1, 1, dtype=dtype)


def pool2x(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] average pool, window 3, stride 2, pad 1."""
    return nchw(avg_pool2d(nhwc(x), 3, 2, 1))


def pool4x(x: torch.Tensor) -> torch.Tensor:
    return nchw(avg_pool2d(nhwc(x), 5, 4, 1))


def _interp(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] x resized bilinearly (align_corners=True) to like's H, W."""
    return nchw(interp_bilinear(nhwc(x), like.shape[2:]))


class ConvGRU(nn.Module):
    """ConvGRU whose gates take precomputed context biases (cz, cr, cq)."""

    def __init__(self, hidden_dim: int, input_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.convz = _conv3(hidden_dim + input_dim, hidden_dim, dtype)
        self.convr = _conv3(hidden_dim + input_dim, hidden_dim, dtype)
        self.convq = _conv3(hidden_dim + input_dim, hidden_dim, dtype)

    def forward(self, h: torch.Tensor, context, *inputs: torch.Tensor) -> torch.Tensor:
        cz, cr, cq = context
        x = torch.cat(inputs, dim=1)
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1.0 - z) * h + z * q


class SepConvGRU(nn.Module):
    """Separable ConvGRU: a 1x5 (horizontal) GRU step, then a 5x1 (vertical)
    one.  Takes the context biases of `ConvGRU`'s signature and drops them,
    as the JAX twin's cell has no context-bias form."""

    def __init__(self, hidden_dim: int, input_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        for tag, kernel, pad in (("h", (1, 5), (0, 2)), ("v", (5, 1), (2, 0))):
            for gate in ("convz", "convr", "convq"):
                self.add_module(f"{gate}{tag}", Conv(hidden_dim + input_dim, hidden_dim, kernel, 1,
                                                     pad, dtype=dtype))

    def forward(self, h: torch.Tensor, context, *inputs: torch.Tensor) -> torch.Tensor:
        x = torch.cat(inputs, dim=1)
        for tag in ("h", "v"):
            convz, convr, convq = (getattr(self, f"{gate}{tag}") for gate in ("convz", "convr", "convq"))
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(convz(hx))
            r = torch.sigmoid(convr(hx))
            q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
            h = (1.0 - z) * h + z * q
        return h


class BasicMotionEncoder(nn.Module):
    """Lookup features + current disparity → 128-ch motion features (the
    last channel is the disparity itself).

    `disp` is [B, 1, H, W] (channels-last strides, (H*W, 1, W, 1), so that
    the closing concatenation keeps the layout).  `corr` is the [B, H, W, C]
    lookup or a tuple of its parts (pyramid_lookup split=True: (geo, corr)
    for the IGEV core, (corr,) for RAFT); for a tuple, convc1's 1x1 kernel
    is sliced per part and the partial products are summed in fp32 before
    one cast to the compute dtype, as in the JAX twin.  Either way its
    [B, C, H, W] view is channels-last."""

    def __init__(self, corr_channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.convc1 = Conv(corr_channels, 64, 1, dtype=dtype)
        self.convd1 = Conv(1, 64, 7, 1, 3, dtype=dtype)
        self.convc2 = _conv3(64, 64, dtype)
        self.convd2 = _conv3(64, 64, dtype)
        self.conv = _conv3(128, 127, dtype)

    def forward(self, disp: torch.Tensor, corr) -> torch.Tensor:
        if isinstance(corr, (tuple, list)):
            w = self.convc1.weight[:, :, 0, 0]  # [64, C]
            dt = self.dtype or torch.promote_types(corr[0].dtype, w.dtype)
            acc = self.convc1.bias.float()
            off = 0
            for p in corr:
                n = p.shape[-1]
                wp = w[:, off:off + n].to(dt).float()
                acc = acc + torch.matmul(p.to(dt).float(), wp.t())
                off += n
            c = F.relu(nchw(acc.to(dt)))
        else:
            c = F.relu(self.convc1(nchw(corr)))
        d = F.relu(self.convd1(disp))
        c = F.relu(self.convc2(c))
        d = F.relu(self.convd2(d))
        out = F.relu(self.conv(torch.cat([c, d], dim=1)))
        return torch.cat([out, disp.to(out.dtype)], dim=1)


class DispHead(nn.Module):
    def __init__(self, in_ch: int = 128, hidden: int = 256, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = _conv3(in_ch, hidden, dtype)
        self.conv2 = _conv3(hidden, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class BasicMultiUpdateBlock(nn.Module):
    """net: hidden states [1/4, 1/8, 1/16] ([B, C, H, W], channels-last);
    context: per-level (cz, cr, cq) gate biases, each a channels-last map.
    Each GRU sees the pooled finer state and the upsampled coarser state.
    The conv weights are kept channels-last."""

    def __init__(self, hidden_dims: Sequence[int] = (128, 128, 128), n_layers: int = 3,
                 corr_channels: int = 162, gru_type: str = "conv",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if gru_type not in ("conv", "sep"):
            raise ValueError(f"gru_type must be 'conv' or 'sep', got {gru_type!r}")
        gru = ConvGRU if gru_type == "conv" else SepConvGRU
        self.n_layers = n_layers
        hd = hidden_dims
        if n_layers == 3:
            self.gru16 = gru(hd[0], hd[1], dtype)
        if n_layers >= 2:
            self.gru08 = gru(hd[1], hd[2] + (hd[0] if n_layers == 3 else 0), dtype)
        self.encoder = BasicMotionEncoder(corr_channels, dtype)
        self.gru04 = gru(hd[2], 128 + (hd[1] if n_layers > 1 else 0), dtype)
        self.disp_head = DispHead(hd[2], 256, dtype)
        self.to(memory_format=torch.channels_last)

    def forward(self, net: List[torch.Tensor], context, corr=None, disp=None,
                iter04: bool = True, iter08: bool = True, iter16: bool = True,
                update: bool = True):
        net = list(net)
        if iter16 and self.n_layers == 3:
            net[2] = self.gru16(net[2], context[2], pool2x(net[1]))
        if iter08 and self.n_layers >= 2:
            inputs = [pool2x(net[0])]
            if self.n_layers > 2:
                inputs.append(_interp(net[2], net[1]))
            net[1] = self.gru08(net[1], context[1], *inputs)
        if iter04:
            motion = self.encoder(disp, corr)
            inputs = [motion] + ([_interp(net[1], net[0])] if self.n_layers > 1 else [])
            net[0] = self.gru04(net[0], context[0], *inputs)
        if not update:
            return net, None
        return net, self.disp_head(net[0])
