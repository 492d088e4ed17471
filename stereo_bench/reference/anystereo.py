"""Plain PyTorch reference of the Any-Stereo pipeline with the IGEV and the
RAFT core, as the benchmark's configurations run it.

A frozen, independent copy of the architecture: plain `torch` operations in
float32 (TF32 is switched off by the caller, `set_plain_float32`), no
hand-written kernel, no spatial tiling, only the options the configurations
in `stereo_bench/configs/` use (type5 stems, GroupNorm 2-D / InstanceNorm
3-D, 3 GRU levels, the LIIF decoder with the v2 ISU features and the raw
relative coordinate, the 3x3 disparity combine).  It imports nothing of the
program.  Parameter names equal the program's `state_dict` keys (flax's
auto-names: `Conv_0`, `GroupNorm_1`, ...), so one seeded state dict loads
into both.

The lookup is the pyramid of the papers written out: per level the row
averaged in pairs 2^lvl times (floor), taps at x / 2^lvl - r + k for k in
0..2r, linear interpolation, zero outside the row.  Disparity enters each
iteration detached, as in the program.

`quant`, where given, is applied to both operands of every convolution,
transposed convolution, dense layer and correlation product: the benchmark's
control passes a rounding to float8 there (`fp8_round`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

SUPPORTED = {
    "agg_type": "type5", "norm_2d": "group", "norm_3d": "instance", "n_gru_layers": 3,
    "n_downsample": 2, "slow_fast_gru": False, "gru_type": "conv",
}
SUPPORTED_LIIF = {
    "mlp_hidden": [128, 64, 64], "isu_mode": "with_v2_isu", "isu_window": [3, 3],
    "pos_enc": "none", "decode_cell": False, "local_ensemble": False,
    "quarter_nearest": "none", "taps": 9, "disparity_norm": "none",
}


def set_plain_float32() -> None:
    """Float32 products in float32, not TF32, on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor, fmt: torch.dtype, top: float) -> torch.Tensor:
    """`t` rounded to the float8 format `fmt` under one scale for the whole
    tensor (its largest magnitude at `top`, the format's largest finite
    value), in float32."""
    s = top / t.abs().amax().clamp_min(1e-30)
    return (t * s).to(fmt).float() / s


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3, per-tensor scaled: the forward operands
    of the FP8 recipe of mixed precision (Micikevicius et al., "FP8 Formats
    for Deep Learning", arXiv:2209.05433)."""
    return _fp8(t, torch.float8_e4m3fn, 448.0)


# ------------------------------------------------------------------ layers


class Named(nn.Module):
    """Children named `Kind_n` in order of creation, unless named."""

    def __init__(self):
        super().__init__()
        self._counts: Dict[str, int] = {}

    def add(self, module: nn.Module, name: Optional[str] = None) -> nn.Module:
        if name is None:
            kind = type(module).__name__
            n = self._counts.get(kind, 0)
            self._counts[kind] = n + 1
            name = f"{kind}_{n}"
        self.add_module(name, module)
        return module


def _q(m: nn.Module, t: torch.Tensor) -> torch.Tensor:
    return t if m.quant is None else m.quant(t)


class Conv(nn.Module):
    quant: Quant = None

    def __init__(self, cin, cout, k, stride=1, pad=0, groups=1, bias=True, dims=2):
        super().__init__()
        k = (k,) * dims if isinstance(k, int) else tuple(k)
        self.stride, self.pad, self.groups, self.dims = stride, pad, groups, dims
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, *k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        conv = F.conv2d if self.dims == 2 else F.conv3d
        return conv(_q(self, x), _q(self, self.weight), self.bias, self.stride, self.pad, 1, self.groups)


class TorchConvTranspose(nn.Module):
    quant: Quant = None

    def __init__(self, cin, cout, k, stride, pad, dims, bias=False):
        super().__init__()
        self.stride, self.pad, self.dims = stride, pad, dims
        self.weight = nn.Parameter(torch.zeros(cin, cout, *((k,) * dims)))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        deconv = F.conv_transpose2d if self.dims == 2 else F.conv_transpose3d
        return deconv(_q(self, x), _q(self, self.weight), self.bias, self.stride, self.pad)


class Dense(nn.Module):
    quant: Quant = None

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.linear(_q(self, x), _q(self, self.weight), self.bias)


class GroupNorm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.groups = max(c // 8, 1)
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.group_norm(x, self.groups, self.weight, self.bias, 1e-5)


class LayerNorm2d(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        mu = x.mean(1, keepdim=True)
        var = ((x - mu) ** 2).mean(1, keepdim=True)
        y = (x - mu) / torch.sqrt(var + 1e-6)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return y * self.weight.view(shape) + self.bias.view(shape)


def instance_norm(x):
    dims = tuple(range(2, x.dim()))
    mu = x.mean(dims, keepdim=True)
    var = x.var(dims, unbiased=False, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5)


class InstanceNorm(nn.Module):
    def forward(self, x):
        return instance_norm(x)


class Identity(nn.Module):
    def forward(self, x):
        return x


def make_norm(kind: str, c: int) -> nn.Module:
    return {"group": lambda: GroupNorm(c), "instance": InstanceNorm, "none": Identity}[kind]()


def leaky(x):
    return F.leaky_relu(x, 0.01)


ACTS = {"leaky": leaky, "relu": F.relu, None: lambda x: x}


class ConvNormAct(Named):
    def __init__(self, cin, cout, k, stride=1, pad=0, norm="instance", act="leaky",
                 transpose=False, dims=2):
        super().__init__()
        if transpose:
            conv = self.add(TorchConvTranspose(cin, cout, k, stride, pad, dims, bias=norm == "none"))
        else:
            conv = self.add(Conv(cin, cout, k, stride, pad, bias=norm == "none", dims=dims))
        self.parts = (conv, self.add(make_norm(norm, cout)))
        self.act = ACTS[act]

    def forward(self, x):
        conv, norm = self.parts
        return self.act(norm(conv(x)))


class Conv2x(Named):
    """Transposed conv (k4 s2 p1), nearest resize to the skip if needed,
    concat, 3x3 conv to twice the features."""

    def __init__(self, cin, skip, c):
        super().__init__()
        self.parts = (self.add(ConvNormAct(cin, c, 4, 2, 1, transpose=True)),
                      self.add(ConvNormAct(c + skip, 2 * c, 3, 1, 1)))

    def forward(self, x, skip):
        up, conv = self.parts
        y = up(x)
        if y.shape[2:] != skip.shape[2:]:
            y = F.interpolate(y, size=skip.shape[2:], mode="nearest")
        return conv(torch.cat([y, skip], 1))


# ------------------------------------------------------------ extractors


def relu6(x):
    return x.clamp(0.0, 6.0)


class InvertedResidual(Named):
    def __init__(self, cin, cout, stride, expand):
        super().__init__()
        mid = cin * expand
        self.residual = stride == 1 and cin == cout
        layers = []
        if expand != 1:
            layers += [self.add(Conv(cin, mid, 1, bias=False)), self.add(GroupNorm(mid)), relu6]
        layers += [self.add(Conv(mid, mid, 3, stride, 1, groups=mid, bias=False)),
                   self.add(GroupNorm(mid)), relu6,
                   self.add(Conv(mid, cout, 1, bias=False)), self.add(GroupNorm(cout))]
        self.parts = tuple(layers)

    def forward(self, x):
        y = x
        for f in self.parts:
            y = f(y)
        return y + x if self.residual else y


MBV2 = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2))


class MobileNetV2Trunk(Named):
    def __init__(self):
        super().__init__()
        stem = (self.add(Conv(3, 32, 3, 2, 1, bias=False)), self.add(GroupNorm(32)))
        stages, cin = [], 32
        for t, c, n, s in MBV2:
            stages.append(tuple(self.add(InvertedResidual(cin if i == 0 else c, c, s if i == 0 else 1, t))
                                for i in range(n)))
            cin = c
        self.parts = (stem, tuple(stages))

    def forward(self, x):
        (conv, norm), stages = self.parts
        y = relu6(norm(conv(x)))
        taps = []
        for blocks in stages:
            for b in blocks:
                y = b(y)
            taps.append(y)
        return taps[0], taps[1], taps[2], taps[4], taps[5]


class FeaturePyramid(Named):
    def __init__(self):
        super().__init__()
        self.parts = (self.add(MobileNetV2Trunk()), self.add(Conv2x(160, 96, 96)),
                      self.add(Conv2x(192, 32, 32)), self.add(Conv2x(64, 24, 24)),
                      self.add(ConvNormAct(48, 48, 3, 1, 1)))

    def forward(self, x):
        trunk, up16, up8, up4, head = self.parts
        _, x4, x8, x16, x32 = trunk(x)
        f16 = up16(x32, x16)
        f8 = up8(f16, x8)
        return [head(up4(f8, x4)), f8, f16, x32]


class ResidualBlock(Named):
    def __init__(self, cin, c, stride, norm):
        super().__init__()
        body = (self.add(Conv(cin, c, 3, stride, 1)), self.add(make_norm(norm, c)),
                self.add(Conv(c, c, 3, 1, 1)), self.add(make_norm(norm, c)))
        proj = ()
        if stride != 1 or cin != c:
            proj = (self.add(Conv(cin, c, 1, stride)), self.add(make_norm(norm, c)))
        self.parts = (body, proj)

    def forward(self, x):
        (c1, n1, c2, n2), proj = self.parts
        y = F.relu(n2(c2(F.relu(n1(c1(x))))))
        for f in proj:
            x = f(x)
        return F.relu(x + y)


STAGES = ((64, 1), (96, 2), (128, 2))  # output at 1/4


class BasicEncoder(Named):
    def __init__(self, out_dim):
        super().__init__()
        stem = (self.add(Conv(3, 64, 7, 1, 3)), self.add(InstanceNorm()))
        blocks, cin = [], 64
        for c, s in STAGES:
            blocks += [self.add(ResidualBlock(cin, c, s, "instance")),
                       self.add(ResidualBlock(c, c, 1, "instance"))]
            cin = c
        self.parts = (stem, tuple(blocks), self.add(Conv(128, out_dim, 1)))

    def forward(self, x):
        (conv, norm), blocks, head = self.parts
        y = F.relu(norm(conv(x)))
        for b in blocks:
            y = b(y)
        return head(y)


class MultiBasicEncoder(Named):
    """[(net, inp)] at 1/4, 1/8, 1/16."""

    def __init__(self, hd):
        super().__init__()
        stem, cin = [self.add(Conv(3, 64, 7, 1, 3)), self.add(GroupNorm(64))], 64
        for c, s in STAGES:
            stem += [self.add(ResidualBlock(cin, c, s, "group")), self.add(ResidualBlock(c, c, 1, "group"))]
            cin = c

        def head(dim, res, name):
            r = (self.add(ResidualBlock(128, 128, 1, "group"), f"{name}_res"),) if res else ()
            return r + (self.add(Conv(128, dim, 3, 1, 1), f"{name}_conv"),)

        levels = [(head(hd[2], True, "net04"), head(hd[2], True, "inp04"), ())]
        down = (self.add(ResidualBlock(128, 128, 2, "group")), self.add(ResidualBlock(128, 128, 1, "group")))
        levels.append((head(hd[1], True, "net08"), head(hd[1], True, "inp08"), down))
        down = (self.add(ResidualBlock(128, 128, 2, "group")), self.add(ResidualBlock(128, 128, 1, "group")))
        levels.append((head(hd[0], False, "net16"), head(hd[0], False, "inp16"), down))
        self.parts = (tuple(stem), tuple(levels))

    def forward(self, x):
        stem, levels = self.parts
        y = F.relu(stem[1](stem[0](x)))
        for b in stem[2:]:
            y = b(y)
        out = []
        for net_head, inp_head, down in levels:
            for b in down:
                y = b(y)
            n, i = y, y
            for f in net_head:
                n = f(n)
            for f in inp_head:
                i = f(i)
            out.append((n, i))
        return out


class HighResAggregation(Named):
    """Type5 stem: PixelUnshuffle(2) → conv+IN+leaky → squeeze-excite gate →
    3x3 conv → LayerNorm2d → GELU."""

    def __init__(self, cin, c):
        super().__init__()
        self.parts = (self.add(ConvNormAct(4 * cin, c, 3, 1, 1)), self.add(Conv(c, c, 1)),
                      self.add(Conv(c, c, 3, 1, 1, bias=False)), self.add(LayerNorm2d(c)))

    def forward(self, x):
        embed, gate, conv, norm = self.parts
        y = embed(F.pixel_unshuffle(x, 2))
        y = y * gate(y.mean(dim=(2, 3), keepdim=True))
        return F.gelu(norm(conv(y)))


class StemBranch(Named):
    def __init__(self):
        super().__init__()
        self.parts = (self.add(HighResAggregation(3, 32), "stem_2"),
                      self.add(HighResAggregation(32, 48), "stem_4"))

    def forward(self, x):
        s2 = self.parts[0](x)
        return s2, self.parts[1](s2)


# ------------------------------------------------------------ cost stage


class FeatureAtt(Named):
    def __init__(self, cv, fc):
        super().__init__()
        self.parts = (self.add(ConvNormAct(fc, fc // 2, 1, 1, 0, norm="group")),
                      self.add(Conv(fc // 2, cv, 1)))

    def forward(self, vol, feat):
        c1, c2 = self.parts
        return torch.sigmoid(c2(c1(feat))).unsqueeze(2) * vol


class _Conv3dBlock(Named):
    def __init__(self, cin, c, k=3, stride=1, pad=1, transpose=False, norm="instance", act="leaky"):
        super().__init__()
        self.parts = (self.add(ConvNormAct(cin, c, 4 if transpose else k, stride, pad, norm, act,
                                           transpose, dims=3)),)

    def forward(self, x):
        return self.parts[0](x)


class CostAggregation(Named):
    """Hourglass over the GWC volume [B, 8, D, H, W] guided by the left
    features at 1/4 .. 1/32; output [B, 8, D, H, W]."""

    def __init__(self, c=8, feat=(96, 64, 192, 160)):
        super().__init__()
        f4, f8, f16, f32 = feat

        def blk(i, o, **kw):
            return self.add(_Conv3dBlock(i, o, **kw))

        def att(cv, fc):
            return self.add(FeatureAtt(cv, fc))

        stem = (blk(c, c), att(c, f4))
        d1 = (blk(c, 2 * c, stride=2), blk(2 * c, 2 * c), att(2 * c, f8))
        d2 = (blk(2 * c, 4 * c, stride=2), blk(4 * c, 4 * c), att(4 * c, f16))
        d3 = (blk(4 * c, 6 * c, stride=2), blk(6 * c, 6 * c), att(6 * c, f32))
        u2 = (blk(6 * c, 4 * c, stride=2, transpose=True), blk(8 * c, 4 * c, k=1, pad=0),
              blk(4 * c, 4 * c), blk(4 * c, 4 * c), att(4 * c, f16))
        u1 = (blk(4 * c, 2 * c, stride=2, transpose=True), blk(4 * c, 2 * c, k=1, pad=0),
              blk(2 * c, 2 * c), blk(2 * c, 2 * c), att(2 * c, f8))
        out = self.add(_Conv3dBlock(2 * c, 8, stride=2, transpose=True, norm="none", act=None))
        self.parts = (stem, d1, d2, d3, u2, u1, out)

    def forward(self, v, feats):
        stem, d1, d2, d3, u2, u1, out = self.parts
        v = stem[1](stem[0](v), feats[0])
        a = d1[2](d1[1](d1[0](v)), feats[1])
        b = d2[2](d2[1](d2[0](a)), feats[2])
        c = d3[2](d3[1](d3[0](b)), feats[3])
        y = torch.cat([u2[0](c), b], 1)
        y = u2[4](u2[3](u2[2](u2[1](y))), feats[2])
        y = torch.cat([u1[0](y), a], 1)
        y = u1[4](u1[3](u1[2](u1[1](y))), feats[1])
        return out(y)


def shift_right(x: torch.Tensor, d: int) -> torch.Tensor:
    """x[:, :, w - d] along W (dim 2) of [B, H, W, ...], zero for w < d."""
    if d == 0:
        return x
    out = torch.zeros_like(x)
    out[:, :, d:] = x[:, :, :-d]
    return out


def gwc_volume(fl, fr, d_max, groups):
    """[B, H, W, G, D]: mean over each group's channels of fl[w] * fr[w - d]."""
    b, h, w, c = fl.shape
    fl = fl.reshape(b, h, w, groups, c // groups)
    fr = fr.reshape(b, h, w, groups, c // groups)
    return torch.stack([(fl * shift_right(fr, d)).mean(-1) for d in range(d_max)], -1)


# ---------------------------------------------------------------- lookup


def pooled_levels(rows: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Level 0 and each coarser level: the one before averaged in pairs
    along the last axis (an odd last entry dropped)."""
    out = [rows]
    for _ in range(levels - 1):
        r = out[-1]
        n = r.shape[-1] // 2
        out.append(r[..., : 2 * n].reshape(*r.shape[:-1], n, 2).mean(-1))
    return out


def linear_taps(row: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """row [R, L] at positions pos [R, K], linearly; entries outside
    [0, L - 1] read zero."""
    n = row.shape[-1]
    x0 = torch.floor(pos)
    w1 = pos - x0
    i0 = x0.long()
    out = torch.zeros_like(pos)
    for idx, w in ((i0, 1.0 - w1), (i0 + 1, w1)):
        ok = (idx >= 0) & (idx < n)
        out = out + torch.where(ok, torch.gather(row, 1, idx.clamp(0, max(n - 1, 0))), 0.0) * w
    return out


def pyramid_taps(levels: List[torch.Tensor], x: torch.Tensor, radius: int) -> torch.Tensor:
    """[R, n_levels * (2r+1)], level-major: level i's taps at
    x / 2^i - r + k."""
    k = torch.arange(2 * radius + 1, dtype=x.dtype, device=x.device)
    out = []
    for i, lv in enumerate(levels):
        if lv.shape[-1] == 0:
            out.append(x.new_zeros(x.shape[0], k.numel()))
        else:
            out.append(linear_taps(lv, (x * 2.0 ** -i - radius)[:, None] + k))
    return torch.cat(out, -1)


# ---------------------------------------------------------------- update


class ConvGRU(nn.Module):
    def __init__(self, hidden, inp):
        super().__init__()
        self.convz = Conv(hidden + inp, hidden, 3, 1, 1)
        self.convr = Conv(hidden + inp, hidden, 3, 1, 1)
        self.convq = Conv(hidden + inp, hidden, 3, 1, 1)

    def forward(self, h, ctx, *inputs):
        cz, cr, cq = ctx
        x = torch.cat(inputs, 1)
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], 1)) + cq)
        return (1.0 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_ch):
        super().__init__()
        self.convc1 = Conv(corr_ch, 64, 1)
        self.convd1 = Conv(1, 64, 7, 1, 3)
        self.convc2 = Conv(64, 64, 3, 1, 1)
        self.convd2 = Conv(64, 64, 3, 1, 1)
        self.conv = Conv(128, 127, 3, 1, 1)

    def forward(self, disp, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        d = F.relu(self.convd2(F.relu(self.convd1(disp))))
        return torch.cat([F.relu(self.conv(torch.cat([c, d], 1))), disp], 1)


class DispHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv(128, 256, 3, 1, 1)
        self.conv2 = Conv(256, 1, 3, 1, 1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


def pool2x(x):
    return F.avg_pool2d(x, 3, 2, 1)


def resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] weights of a bilinear resize with align_corners: output
    i reads position i * (n_in - 1) / (n_out - 1)."""
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    pos = i * ((n_in - 1) / max(n_out - 1, 1))
    i0 = torch.floor(pos).clamp(0, max(n_in - 2, 0))
    f = (pos - i0)[:, None]
    j = torch.arange(n_in, dtype=torch.float32, device=device)[None]
    return (1.0 - f) * (j == i0[:, None]).float() + f * (j == (i0[:, None] + 1)).float()


def resize_like(x, like):
    """Bilinear (align_corners) resize of [B, C, H, W] to `like`'s size, as
    one product along each axis."""
    (h, w), (oh, ow) = x.shape[2:], like.shape[2:]
    y = torch.einsum("oh,bchw->bcow", resize_matrix(h, oh, x.device), x)
    return torch.einsum("pw,bcow->bcop", resize_matrix(w, ow, x.device), y)


class BasicMultiUpdateBlock(nn.Module):
    def __init__(self, hd, corr_ch):
        super().__init__()
        self.gru16 = ConvGRU(hd[0], hd[1])
        self.gru08 = ConvGRU(hd[1], hd[2] + hd[0])
        self.encoder = BasicMotionEncoder(corr_ch)
        self.gru04 = ConvGRU(hd[2], 128 + hd[1])
        self.disp_head = DispHead()

    def forward(self, net, ctx, corr, disp):
        net = list(net)
        net[2] = self.gru16(net[2], ctx[2], pool2x(net[1]))
        net[1] = self.gru08(net[1], ctx[1], pool2x(net[0]), resize_like(net[2], net[1]))
        motion = self.encoder(disp, corr)
        net[0] = self.gru04(net[0], ctx[0], motion, resize_like(net[1], net[0]))
        return net, self.disp_head(net[0])


# ---------------------------------------------------------------- decoder


def nearest_index(c: torch.Tensor, n: int) -> torch.Tensor:
    """Normalized coordinate in (-1, 1) → nearest of n cell indices
    (half-pixel centres, round half to even, clamped)."""
    return torch.round(((c.clamp(-1 + 1e-6, 1 - 1e-6) + 1.0) * n - 1.0) * 0.5).long().clamp(0, n - 1)


def cell_centre(i: torch.Tensor, n: int) -> torch.Tensor:
    return -1.0 + (2.0 * i.float() + 1.0) / n


def axis_centres(n: int, device) -> torch.Tensor:
    return -1.0 + (2.0 * torch.arange(n, dtype=torch.float32, device=device) + 1.0) / n


def affinity(feat: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] → [B, H, W, 8]: cosine with each of the 3x3 neighbours
    (zero past the border), clamped at 0."""
    fn = feat / torch.sqrt((feat * feat).sum(-1, keepdim=True)).clamp_min(1e-12)
    _, h, w, _ = feat.shape
    p = F.pad(fn, (0, 0, 1, 1, 1, 1))
    outs = [(fn * p[:, ky:ky + h, kx:kx + w]).sum(-1)
            for ky in range(3) for kx in range(3) if (ky, kx) != (1, 1)]
    return torch.stack(outs, -1).clamp_min(0.0)


def unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W] → [B, H, W, 9], zero padded, kernel row-major."""
    _, h, w = x.shape
    p = F.pad(x, (1, 1, 1, 1))
    return torch.stack([p[:, ky:ky + h, kx:kx + w] for ky in range(3) for kx in range(3)], -1)


class Mlp(Named):
    def __init__(self, dims):
        super().__init__()
        self.parts = tuple(self.add(Dense(a, b)) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for layer in self.parts[:-1]:
            x = F.relu(layer(x))
        return self.parts[-1](x)


class LiifDecoder(Named):
    def __init__(self, channels: Sequence[int], hidden: Sequence[int], taps: int):
        super().__init__()
        self.imnet = Mlp([sum(channels) + 8 * len(channels) + 2 * len(channels), *hidden, taps])

    @staticmethod
    def with_isu(f):
        return torch.cat([f, affinity(f.detach())], -1)

    def dense(self, feats, ys, xs):
        """Tap logits at the grid ys [H'] x xs [W'] → [B, H', W', taps]."""
        oh, ow = ys.shape[0], xs.shape[0]
        pieces = []
        for f in feats:
            f = self.with_isu(f)
            b, fh, fw, _ = f.shape
            iy, ix = nearest_index(ys, fh), nearest_index(xs, fw)
            q = f[:, iy][:, :, ix]
            ry = (ys - cell_centre(iy, fh)) * fh
            rx = (xs - cell_centre(ix, fw)) * fw
            rel = torch.stack([ry[:, None].expand(oh, ow), rx[None, :].expand(oh, ow)], -1)
            pieces.append(torch.cat([q, rel.expand(b, oh, ow, 2)], -1))
        return self.imnet(torch.cat(pieces, -1))

    def queries(self, feats, coords):
        """Tap logits at coords [B, Q, 2] (y, x) → [B, Q, taps]."""
        pieces = []
        for f in feats:
            f = self.with_isu(f)
            b, fh, fw, c = f.shape
            iy, ix = nearest_index(coords[..., 0], fh), nearest_index(coords[..., 1], fw)
            q = torch.gather(f.reshape(b, fh * fw, c), 1, (iy * fw + ix)[..., None].expand(-1, -1, c))
            rel = torch.stack([(coords[..., 0] - cell_centre(iy, fh)) * fh,
                               (coords[..., 1] - cell_centre(ix, fw)) * fw], -1)
            pieces.append(torch.cat([q, rel], -1))
        return self.imnet(torch.cat(pieces, -1))


# ------------------------------------------------------------------ model


class AnyStereoReference(nn.Module):
    """`forward(left, right, iters, scale, coords=None)`: images
    [B, H, W, 3] in 0..255; decodes densely at the input's pixel centres
    ([B, H, W]) or at `coords` ([B, Q]) after the last iteration."""

    def __init__(self, model: dict, quant: Quant = None):
        super().__init__()
        for key, want in SUPPORTED.items():
            if model.get(key, want) != want:
                raise ValueError(f"the reference computes {key}={want!r}, not {model[key]!r}")
        liif = model.get("liif", {})
        for key, want in SUPPORTED_LIIF.items():
            if liif.get(key, want) != want:
                raise ValueError(f"the reference computes liif.{key}={want!r}, not {liif[key]!r}")
        self.core = model["core"]
        self.levels, self.radius = model["corr_levels"], model["corr_radius"]
        self.d_max, self.groups = model["max_disp"] // 4, model.get("gwc_groups", 8)
        hd = tuple(model["hidden_dims"])
        taps = 2 * self.radius + 1
        if self.core == "igev":
            self.feature = FeaturePyramid()
            self.conv = ConvNormAct(96, 96, 3, 1, 1)
            self.desc = Conv(96, 96, 1)
            self.cost_agg = CostAggregation(self.groups)
            self.classifier = Conv(8, 1, 3, 1, 1, bias=False, dims=3)
            corr_ch = self.levels * taps * (self.groups + 1)
        elif self.core == "raft":
            self.fnet = BasicEncoder(model["fnet_dim"])
            corr_ch = self.levels * taps
        else:
            raise ValueError(f"core {self.core!r}")
        self.stems = StemBranch()
        self.cnet = MultiBasicEncoder(hd)
        for i in range(3):
            self.add_module(f"context_zqr_{i}", Conv(hd[2 - i], 3 * hd[2 - i], 3, 1, 1))
        self.update_block = BasicMultiUpdateBlock(hd, corr_ch)
        self.liif = LiifDecoder((48 + hd[2], 32), SUPPORTED_LIIF["mlp_hidden"], SUPPORTED_LIIF["taps"])
        for m in self.modules():
            if hasattr(type(m), "quant"):
                m.quant = quant
        self.quant = quant

    def _correlate(self, a, b):
        q = self.quant or (lambda t: t)
        return torch.matmul(q(a), q(b).transpose(-1, -2))

    def _stages(self, left, right):
        """Everything before the iterations: (pyramids, initial disparity,
        hidden states, context biases, stems)."""
        b = left.shape[0]
        left = (2.0 * (left / 255.0) - 1.0).permute(0, 3, 1, 2)
        right = (2.0 * (right / 255.0) - 1.0).permute(0, 3, 1, 2)
        s2, s4 = self.stems(left)
        if self.core == "igev":
            fl, fr = self.feature(left), self.feature(right)
            f4l = torch.cat([fl[0], s4], 1)
            f4r = torch.cat([fr[0], self.stems(right)[1]], 1)
            ml = self.desc(self.conv(f4l)).permute(0, 2, 3, 1)
            mr = self.desc(self.conv(f4r)).permute(0, 2, 3, 1)
            q = self.quant or (lambda t: t)
            gwc = gwc_volume(q(ml), q(mr), self.d_max, self.groups)  # [B, H, W, G, D]
            corr = self._correlate(ml, mr)  # [B, H, W, W]
            gev = self.cost_agg(gwc.permute(0, 3, 4, 1, 2), [f4l] + fl[1:])
            prob = torch.softmax(self.classifier(gev)[:, 0], 1)  # [B, D, H, W]
            d = torch.arange(self.d_max, dtype=prob.dtype, device=prob.device)
            disp = (prob * d[:, None, None]).sum(1)
            geo = gev.permute(0, 3, 4, 1, 2)  # [B, H, W, 8, D]
            pyr = {"geo": pooled_levels(geo.reshape(-1, self.d_max), self.levels),
                   "corr": pooled_levels(corr.reshape(-1, corr.shape[-1]), self.levels)}
        else:
            ml = self.fnet(left).permute(0, 2, 3, 1)
            mr = self.fnet(right).permute(0, 2, 3, 1)
            corr = self._correlate(ml, mr)
            disp = torch.zeros(ml.shape[:3], dtype=torch.float32, device=ml.device)
            pyr = {"corr": pooled_levels(corr.reshape(-1, corr.shape[-1]), self.levels)}
        cnet = self.cnet(left)
        net = [torch.tanh(n) for n, _ in cnet]
        ctx = [getattr(self, f"context_zqr_{i}")(F.relu(inp)).chunk(3, 1) for i, (_, inp) in enumerate(cnet)]
        return pyr, disp, net, ctx, (s2, s4)

    def _lookup(self, pyr, disp):
        b, h, w = disp.shape
        out = []
        if "geo" in pyr:
            x = disp[..., None].expand(b, h, w, self.groups).reshape(-1)
            out.append(pyramid_taps(pyr["geo"], x, self.radius).reshape(b, h, w, -1))
        cx = torch.arange(w, dtype=torch.float32, device=disp.device) - disp
        out.append(pyramid_taps(pyr["corr"], cx.reshape(-1), self.radius).reshape(b, h, w, -1))
        return torch.cat(out, -1).permute(0, 3, 1, 2)

    def iterate(self, net, disp, pyr, ctx):
        net, delta = self.update_block(net, ctx, self._lookup(pyr, disp), disp[:, None])
        return net, disp + delta[:, 0]

    @staticmethod
    def _latents(hidden, stems):
        s2, s4 = stems
        return [torch.cat([s4, hidden], 1).permute(0, 2, 3, 1), s2.permute(0, 2, 3, 1)]

    def decode_dense(self, disp, hidden, stems, scale, out_hw):
        ys, xs = axis_centres(out_hw[0], disp.device), axis_centres(out_hw[1], disp.device)
        wts = torch.softmax(self.liif.dense(self._latents(hidden, stems), ys, xs), -1)
        h, w = disp.shape[1:]
        taps = unfold3x3(disp * 4.0 * scale[:, None, None])
        taps = taps[:, nearest_index(ys, h)][:, :, nearest_index(xs, w)]
        return (taps * wts).sum(-1)

    def decode_queries(self, disp, hidden, stems, scale, coords):
        wts = torch.softmax(self.liif.queries(self._latents(hidden, stems), coords), -1)
        b, h, w = disp.shape
        taps = unfold3x3(disp * 4.0 * scale[:, None, None]).reshape(b, h * w, 9)
        idx = nearest_index(coords[..., 0], h) * w + nearest_index(coords[..., 1], w)
        return (torch.gather(taps, 1, idx[..., None].expand(-1, -1, 9)) * wts).sum(-1)

    def forward(self, left, right, iters, scale, coords=None):
        pyr, disp, net, ctx, stems = self._stages(left, right)
        for _ in range(iters):
            net, disp = self.iterate(net, disp, pyr, ctx)
        if coords is not None:
            return self.decode_queries(disp, net[0], stems, scale, coords)
        return self.decode_dense(disp, net[0], stems, scale, left.shape[1:3])


def param_kinds(model: nn.Module) -> Dict[str, str]:
    """How each parameter is drawn: "fan_in" for a convolution's or dense
    layer's weight (normal / sqrt(fan in)), "scale" for a norm's weight,
    "bias" for any bias."""
    kinds = {}
    for name, p in model.named_parameters():
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        if name.endswith("bias"):
            kinds[name] = "bias"
        elif isinstance(owner, (Conv, Dense)):
            kinds[name] = "fan_in"
        elif isinstance(owner, TorchConvTranspose):
            kinds[name] = "fan_in_t"
        else:
            kinds[name] = "scale"
    return kinds


def fan_in(shape, kind: str) -> int:
    """Inputs a weight's output sees: [O, I, *k] → I * prod(k); a
    transposed conv's [I, O, *k] → I * prod(k), as flax counts it."""
    if kind == "fan_in_t":
        return shape[0] * math.prod(shape[2:])
    return math.prod(shape[1:])


def build(model: dict, quant: Quant = None) -> AnyStereoReference:
    """The reference for a configuration's "model" fields."""
    return AnyStereoReference(model, quant)
