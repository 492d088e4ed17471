"""Conv / norm building blocks (twin of `anystereo_tpu/nn/layers.py`).

Layout inside the modules is channels-first (NCHW / NCDHW).  Every module
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
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from anystereo_tpu_torch.config import NormType
from anystereo_tpu_torch.ops.sampling import nearest_resize

IntOrSeq = Union[int, Sequence[int]]


def _tup(v: IntOrSeq, n: int):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


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
        y = conv(x.to(dt), self.weight.to(dt), None, self.stride, self.padding, 1, self.groups)
        if self.bias is not None:
            y = y + _bcast(self.bias.to(dt), y.dim())
        return y


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
        y = deconv(x.to(dt), self.weight.to(dt), None, self.stride, self.padding)
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
    xf = x.float()
    mu = xf.mean(dims, keepdim=True).to(x.dtype)
    var = xf.var(dims, unbiased=False, keepdim=True).to(x.dtype)
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
        return F.group_norm(x.float(), self.groups, self.weight, self.bias, 1e-5).to(dt)


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
