"""Conv / norm building blocks (twin of `anystereo_tpu/nn/layers.py`).

Shapes are channels-first ([B, C, H, W] / [B, C, D, H, W]); the memory
layout is the maps' own: the encoders' are contiguous, the update block's
channels-last (`nn/update.py`).  Every module
names its children the way flax's compact auto-naming names the JAX twin's
(`Conv_0`, `GroupNorm_1`, ...), so the flax variables load by path
(`utils/weights.from_flax`).

Precision follows the flax modules: parameters are fp32; a layer with a
`dtype` casts its input and parameters to it and returns that dtype, and a
layer without one computes in the promoted type of input and parameters.
Convs add their bias after the product, in the compute dtype, as flax does.
The JAX package's TPU schedule rewrites of these layers (folded 3x3x3
convs, the subpixel 3-D deconv) are computed here as the plain conv3d and
conv_transpose3d they stand for.

Inside a spatial context (`parallel/spatial.py`: a rank holds a tile of the
frame's rows) the convolutions exchange the rows their kernels need along H
with the neighbouring ranks and convolve with no H padding, and the
normalisations take their statistics over the whole image.  H is the
second-to-last dim of both layouts.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from anystereo_tpu_torch.config import NormType
from anystereo_tpu_torch.ops.sampling import nearest_resize
from anystereo_tpu_torch.parallel import spatial

IntOrSeq = Union[int, Sequence[int]]


def _tup(v: IntOrSeq, n: int):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] → [B, H, W, C], a view (contiguous for a channels-last x)."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] → [B, C, H, W], a view (channels-last for a contiguous x)."""
    return x.permute(0, 3, 1, 2)


def _bcast(v: torch.Tensor, nd: int) -> torch.Tensor:
    """Per-channel vector → shape broadcastable over [B, C, *spatial]."""
    return v.view(-1, *([1] * (nd - 2)))


class FlaxNamed(nn.Module):
    """Base for modules whose children carry flax's auto-names: the n-th
    child of class `Kind` is `Kind_n` unless it is given a name.  `add`
    registers the child under that name and returns it; subclasses keep
    their handles in a plain tuple (`self.parts`), which nn.Module does not
    register a second time."""

    def __init__(self):
        super().__init__()
        self._kind_counts = {}

    def add(self, module: nn.Module, name: Optional[str] = None) -> nn.Module:
        if name is None:
            kind = type(module).__name__
            n = self._kind_counts.get(kind, 0)
            self._kind_counts[kind] = n + 1
            name = f"{kind}_{n}"
        self.add_module(name, module)
        return module


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(fan_in))


class Conv(nn.Module):
    """flax `nn.Conv`: weight [O, I/groups, *k], explicit symmetric padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel: IntOrSeq, stride: IntOrSeq = 1,
                 padding: IntOrSeq = 0, groups: int = 1, bias: bool = True,
                 dims: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dims, self.groups, self.dtype = dims, groups, dtype
        self.stride, self.padding = _tup(stride, dims), _tup(padding, dims)
        k = _tup(kernel, dims)
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch // groups, *k))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def init_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        conv = F.conv2d if self.dims == 2 else F.conv3d
        padding = self.padding
        ctx = spatial.current()
        if ctx is not None:
            # output row i reads input rows [i*s - p, i*s - p + k): every
            # rank's tile starts at a multiple of s, so each takes p rows
            # before its own and k - s - p after
            k, s, p = self.weight.shape[-2], self.stride[-2], padding[-2]
            x = ctx.halo(x, p, k - s - p, x.dim() - 2)
            padding = padding[:-2] + (0, padding[-1])
        x, w = x.to(dt), self.weight.to(dt)
        # channels-last: C innermost, on a map of more than one pixel (a
        # one-pixel map lies the same either way)
        if self.dims == 2 and self.groups == 1 and x.stride(1) == 1 and x.shape[2] * x.shape[3] > 1:
            y = nhwc_conv2d(x, w, self.stride, padding)
        else:
            y = conv(x, w, None, self.stride, padding, 1, self.groups)
        if self.bias is not None:
            y = y + _bcast(self.bias.to(dt), y.dim())
        return y


def nhwc_conv2d(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int], padding: Sequence[int]
                ) -> torch.Tensor:
    """`F.conv2d(x, w, None, stride, padding)` of a channels-last map, with
    the operands shaped for cuDNN's NHWC kernels, which take channel counts
    in multiples of 8 and otherwise pad or transpose them around the product
    (`nhwcAddPadding`, `nchwToNhwc`, `nhwcToNchw` kernels): a one-channel
    map's taps along W become the channels of a kh x 1 convolution (zeros
    up to 8), and filters are added as zeros up to a multiple of 8 and their
    outputs dropped.  The same products, summed in the kernel's order; the
    result is channels-last."""
    o, i, kh, kw = w.shape
    cl = torch.channels_last
    if i == 1 and kw > 1:
        (ph, pw), (sh, sw), c8 = padding, stride, -(-kw // 8) * 8
        taps = F.pad(x[:, 0], (pw, pw, ph, ph)).unfold(2, kw, sw)  # [B, H + 2ph, W', kw]
        x = nchw(F.pad(taps, (0, c8 - kw)))
        w = F.pad(w[:, 0].transpose(1, 2)[..., None], (0, 0, 0, 0, 0, c8 - kw))  # [O, c8, kh, 1]
        stride, padding = (sh, 1), (0, 0)
    if o % 8:
        w = F.pad(w, (0, 0, 0, 0, 0, 0, 0, -(-o // 8) * 8 - o))
    return F.conv2d(x, w.contiguous(memory_format=cl), None, stride, padding)[:, :o]


class TorchConvTranspose(nn.Module):
    """Transposed conv with torch semantics: weight [I, O, *k]."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int],
                 stride: Sequence[int], padding: Sequence[int], use_bias: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dims, self.dtype = len(kernel), dtype
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.weight = nn.Parameter(torch.zeros(in_ch, out_ch, *kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def init_parameters(self, generator: torch.Generator) -> None:
        # flax's lecun_normal on the [*k, I, O] kernel: fan_in = prod(k) * I
        lecun_normal_(self.weight, self.weight[:, 0].numel(), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        deconv = F.conv_transpose2d if self.dims == 2 else F.conv_transpose3d
        ctx = spatial.current()
        if ctx is None:
            y = deconv(x.to(dt), self.weight.to(dt), None, self.stride, self.padding)
        else:
            # output row j = i*s - p + t reads input rows
            # [ceil((j + p - k + 1) / s), floor((j + p) / s)]: a tile of rows
            # [a0, a1) makes rows [a0*s, a1*s) from lo rows before it and hi
            # after; unpadded, its first row sits at lo*s + p
            k, s, p = self.weight.shape[-2], self.stride[-2], self.padding[-2]
            lo, hi, rows = (k - 1 - p) // s, (p - 1) // s + 1, x.shape[-2]
            x = ctx.halo(x, lo, hi, x.dim() - 2)
            y = deconv(x.to(dt), self.weight.to(dt), None, self.stride, self.padding[:-2] + (0, self.padding[-1]))
            y = y.narrow(y.dim() - 2, lo * s + p, rows * s)
        if self.bias is not None:
            y = y + _bcast(self.bias.to(dt), y.dim())
        return y


class Dense(nn.Module):
    """flax `nn.Dense` over the last axis: weight [O, I].  `init_std`: draw
    the weight from N(0, init_std^2) instead of lecun normal."""

    def __init__(self, in_features: int, out_features: int, dtype: Optional[torch.dtype] = None,
                 bias: bool = True, init_std: Optional[float] = None):
        super().__init__()
        self.dtype, self.init_std = dtype, init_std
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def init_parameters(self, generator: torch.Generator) -> None:
        if self.init_std is None:
            lecun_normal_(self.weight, self.weight.shape[1], generator)
        else:
            with torch.no_grad():
                self.weight.copy_(torch.randn(self.weight.shape, generator=generator) * self.init_std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` over the last axis (biased variance), in the
    promoted type of input and parameters."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return F.layer_norm(x.to(dt), self.weight.shape, self.weight, self.bias, self.eps)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm without affine over all spatial dims of [B, C, *sp].
    Statistics are reduced in fp32 and rounded to x's dtype, then the
    normalization runs in x's dtype, as `jnp.mean` / `jnp.var` do."""
    dims = tuple(range(2, x.dim()))
    ctx = spatial.current()
    if ctx is None:
        xf = x.float()
        mu, var = xf.mean(dims, keepdim=True), xf.var(dims, unbiased=False, keepdim=True)
    else:
        mu, var = ctx.moments(x, dims, x.dim() - 2)
    mu, var = mu.to(x.dtype), var.to(x.dtype)
    return (x - mu) * torch.rsqrt(var + eps)


class InstanceNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm(num_groups=max(C // 8, 1), epsilon=1e-5)`:
    statistics and normalization in fp32, result in `dtype` (or fp32)."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.groups, self.dtype = max(features // 8, 1), dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, torch.float32)
        ctx = spatial.current()
        if ctx is None:
            return F.group_norm(x.float(), self.groups, self.weight, self.bias, 1e-5).to(dt)
        xg = x.reshape(x.shape[0], self.groups, -1, *x.shape[2:])  # [B, G, C/G, *spatial]
        mu, var = ctx.moments(xg, tuple(range(2, xg.dim())), xg.dim() - 2)
        y = ((xg.float() - mu) * torch.rsqrt(var + 1e-5)).reshape(x.shape)
        return (y * _bcast(self.weight, y.dim()) + _bcast(self.bias, y.dim())).to(dt)


class LayerNorm2d(nn.Module):
    """Channel-wise LayerNorm per pixel (eps 1e-6, biased variance), in
    x's dtype."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(1, keepdim=True)
        var = ((x - mu) ** 2).mean(1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + self.eps)
        nd = x.dim()
        return y * _bcast(self.weight.to(x.dtype), nd) + _bcast(self.bias.to(x.dtype), nd)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics: a per-channel affine transform."""

    def __init__(self, features: int, eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        nd = x.dim()
        return x * _bcast(inv.to(dt), nd) + _bcast(shift.to(dt), nd)


class Identity(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def make_norm(kind: NormType, features: int, dtype: Optional[torch.dtype] = None) -> nn.Module:
    if kind is NormType.INSTANCE:
        return InstanceNorm()
    if kind is NormType.FROZEN_BATCH:
        return FrozenBatchNorm(features, dtype=dtype)
    if kind is NormType.LAYER:
        return LayerNorm2d(features)
    if kind is NormType.GROUP:
        return GroupNorm(features, dtype=dtype)
    if kind is NormType.NONE:
        return Identity()
    raise ValueError(kind)


ACTS: dict = {
    "leaky": lambda x: F.leaky_relu(x, 0.01),
    "relu": F.relu,
    "relu6": lambda x: x.clamp(0.0, 6.0),
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "tanh": torch.tanh,
    None: lambda x: x,
}


class ConvNormAct(FlaxNamed):
    """conv (bias only when un-normed) → norm → activation, 2-D or 3-D,
    optionally transposed."""

    def __init__(self, in_ch: int, features: int, kernel: IntOrSeq, stride: IntOrSeq = 1,
                 padding: IntOrSeq = 0, norm: NormType = NormType.INSTANCE,
                 act: Optional[str] = "leaky", transpose: bool = False, dims: int = 2,
                 use_bias: Optional[bool] = None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        bias = (norm is NormType.NONE) if use_bias is None else use_bias
        if transpose:
            conv = self.add(TorchConvTranspose(
                in_ch, features, _tup(kernel, dims), _tup(stride, dims),
                _tup(padding, dims), use_bias=bias, dtype=dtype))
        else:
            conv = self.add(Conv(in_ch, features, kernel, stride, padding,
                                 bias=bias, dims=dims, dtype=dtype))
        self.parts = (conv, self.add(make_norm(norm, features, dtype)))
        self.act: Callable = ACTS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, norm = self.parts
        return self.act(norm(conv(x)))


class Conv2x(FlaxNamed):
    """Strided (or transposed) conv, concat (or add) with a skip, 3x3 conv."""

    def __init__(self, in_ch: int, skip_ch: int, features: int, deconv: bool = False,
                 concat: bool = True, keep_concat: bool = True,
                 norm: NormType = NormType.INSTANCE, act: Optional[str] = "leaky",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.concat = concat
        conv1 = self.add(ConvNormAct(
            in_ch, features, 4 if deconv else 3, stride=2, padding=1, norm=norm,
            act="leaky", transpose=deconv, dtype=dtype))
        if concat:
            mid, out_ch = features + skip_ch, features * (2 if keep_concat else 1)
        else:
            mid, out_ch = features, features
        self.parts = (conv1, self.add(ConvNormAct(mid, out_ch, 3, stride=1, padding=1,
                                                  norm=norm, act=act, dtype=dtype)))

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        conv1, conv2 = self.parts
        y = conv1(x)
        if y.shape[2:] != skip.shape[2:]:
            y = nearest_resize(y.permute(0, 2, 3, 1), skip.shape[2:]).permute(0, 3, 1, 2)
        y = torch.cat([y, skip], dim=1) if self.concat else y + skip
        return conv2(y)


def pixel_unshuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Space-to-depth of [B, C, H, W] in torch PixelUnshuffle channel order
    (out channel c*r*r + dy*r + dx)."""
    return F.pixel_unshuffle(x, r)


def init_parameters(module: nn.Module, seed: int) -> nn.Module:
    """Fill every conv / dense weight from a seeded CPU generator (lecun
    normal, as flax's default); biases stay zero, norm scales one."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "init_parameters"):
            m.init_parameters(g)
    return module
