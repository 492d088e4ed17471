"""LIIF implicit decoder (twin of `anystereo_tpu/nn/liif.py`): per-query MLP
weights that combine a 3x3 (or 4-tap) neighborhood of the low-res disparity
at any continuous output scale.

The decoder has two forms, the query decode at scattered coordinates
(training, and eval with `coords`) and the dense separable decode over an
output grid (eval), and both cover every mode of `LiifConfig`: the ISU
feature augmentation (every `IsuMode`), the cell input, the positional
encoders (`spatial`, `sinusoid`, `ipe`, `learn`, `dpb`), 4-nearest latent
sampling (`quarter_nearest="both"`) and the 4-neighbor local ensemble.  The
dense form stays separable in the 4-nearest and ensemble modes because
their corner shifts are per axis.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from anystereo_tpu_torch.config import IsuMode, LiifConfig, PosEncType
from anystereo_tpu_torch.nn.layers import Dense, FlaxNamed, LayerNorm
from anystereo_tpu_torch.ops.sampling import (
    nearest_dense_gather,
    nearest_latent_coords,
    nearest_sample,
)
from anystereo_tpu_torch.ops.upsample import _clamp_coords, quarter_shifts
from anystereo_tpu_torch.parallel import spatial


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
    ctx = spatial.current()
    if ctx is None:
        padded = F.pad(fn, (0, 0, px, px, py, py))
    else:
        # a rank that holds a tile of the rows reads its neighbours' rows
        padded = F.pad(ctx.halo(fn, py, py, 1), (0, 0, px, px))
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


def _frequency_bank(n: int, hi: float, minus_one: bool) -> np.ndarray:
    """[2n, 2] bank of log-spaced frequencies, n on y then n on x."""
    b = 2.0 ** np.linspace(0, hi, n) - (1.0 if minus_one else 0.0)
    bank = np.stack([b, np.zeros_like(b)], axis=-1)
    return np.concatenate([bank, np.roll(bank, 1, axis=-1)], axis=0)


class SpatialEncoding(torch.nn.Module):
    """Log-spaced Fourier features [x, sin(x Mᵀ), cos(x Mᵀ)] of the 2-D
    relative coordinate, with the learnable frequency matrix `emb`."""

    def __init__(self, out_dim: int, sigma: float = 6.0, in_dim: int = 2):
        super().__init__()
        if out_dim % (2 * in_dim) != 0:
            raise ValueError(f"pos_dim {out_dim} is not a multiple of {2 * in_dim}")
        n = out_dim // 2 // in_dim
        m = 2.0 ** np.linspace(0, sigma, n)
        m = np.stack([m] + [np.zeros_like(m)] * (in_dim - 1), axis=-1)
        m = np.concatenate([np.roll(m, i, axis=-1) for i in range(in_dim)], axis=0)
        self.emb = torch.nn.Parameter(torch.tensor(m, dtype=torch.float32))
        self.out_features = out_dim + in_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.emb.t().to(x.dtype)
        return torch.cat([x, torch.sin(y), torch.cos(y)], dim=-1)


class SinusoidPositionEncoder(FlaxNamed):
    """[sin, cos] of the relative coordinate against a fixed bank of
    log-spaced frequencies (2^linspace(0, scale, n) - 1 per axis), projected
    to `head` channels.  With `integrated` (the "ipe" encoder) each feature
    is attenuated by sinc of the query cell against the same bank, which
    averages the encoding over the cell's footprint."""

    out_features = 8

    def __init__(self, enc_dim: int = 8, posenc_scale: float = 10.0, integrated: bool = False):
        super().__init__()
        self.integrated = integrated
        n = max(enc_dim // 4, 1)
        self.register_buffer("bank", torch.tensor(_frequency_bank(n, posenc_scale, True),
                                                  dtype=torch.float32), persistent=False)
        self.parts = (self.add(Dense(4 * n, self.out_features)),)

    def forward(self, rel: torch.Tensor, cell: Optional[torch.Tensor] = None) -> torch.Tensor:
        bank_t = self.bank.t().to(rel.dtype)
        proj = rel @ bank_t
        enc = [torch.sin(proj), torch.cos(proj)]
        if self.integrated:
            carg = cell.to(rel.dtype) @ bank_t
            small = carg.abs() < 1e-8
            safe = torch.where(small, torch.ones_like(carg), carg)
            cp = torch.where(small, torch.ones_like(carg), torch.sin(safe) / safe)
            enc = [e * cp for e in enc]
        return self.parts[0](torch.cat(enc, dim=-1))


class LearnedPositionEncoder(FlaxNamed):
    """Random Fourier features through the trainable projection `Wr` (no
    bias), [sin, cos] / sqrt(hidden) → LayerNorm → Dense → GELU → LayerNorm
    → Dense → GELU → `proj` to `head` channels."""

    out_features = 8

    def __init__(self, hidden_dims: int = 32, enc_dims: int = 24, gamma: float = 1.0):
        super().__init__()
        self.hidden_dims = hidden_dims
        half = hidden_dims // 2
        self.parts = (
            self.add(Dense(2, half, bias=False, init_std=gamma ** -2), "Wr"),
            self.add(LayerNorm(2 * half), "mlp_ln1"),
            self.add(Dense(2 * half, hidden_dims), "mlp_fc1"),
            self.add(LayerNorm(hidden_dims), "mlp_ln2"),
            self.add(Dense(hidden_dims, enc_dims), "mlp_fc2"),
            self.add(Dense(enc_dims, self.out_features), "proj"),
        )

    def forward(self, rel: torch.Tensor) -> torch.Tensor:
        wr, ln1, fc1, ln2, fc2, proj = self.parts
        p = wr(rel)
        enc = torch.cat([torch.sin(p), torch.cos(p)], dim=-1) / math.sqrt(self.hidden_dims)
        x = F.gelu(fc1(ln1(enc)))
        return proj(F.gelu(fc2(ln2(x))))


class DpbPositionEncoder(FlaxNamed):
    """Dynamic position bias: 2 → h → h → enc with LayerNorm + ReLU between,
    then LayerNorm + ReLU + `proj` to `head` channels.  The head's LayerNorm
    is `hidden_dims` wide and meets the `enc_dims`-wide output, so only
    `enc_dims == hidden_dims` runs (as in the JAX package)."""

    out_features = 8

    def __init__(self, hidden_dims: int = 32, enc_dims: int = 32):
        super().__init__()
        if enc_dims != hidden_dims:
            raise ValueError("the dpb encoder needs enc_dims == hidden_dims, got "
                             f"{enc_dims}, {hidden_dims}")
        self.parts = (
            self.add(Dense(2, hidden_dims), "mlp_fc1"),
            self.add(LayerNorm(hidden_dims), "mlp_ln1"),
            self.add(Dense(hidden_dims, hidden_dims), "mlp_fc2"),
            self.add(LayerNorm(hidden_dims), "mlp_ln2"),
            self.add(Dense(hidden_dims, enc_dims), "mlp_fc3"),
            self.add(LayerNorm(enc_dims), "proj_ln"),
            self.add(Dense(enc_dims, self.out_features), "proj"),
        )

    def forward(self, rel: torch.Tensor) -> torch.Tensor:
        fc1, ln1, fc2, ln2, fc3, proj_ln, proj = self.parts
        x = F.relu(ln1(fc1(rel)))
        x = F.relu(ln2(fc2(x)))
        return proj(F.relu(proj_ln(fc3(x))))


def make_posenc(cfg: LiifConfig) -> Optional[torch.nn.Module]:
    """The positional encoder of one latent, or None for the raw relative
    coordinate."""
    d = max(cfg.pos_dim, 8)
    if cfg.pos_enc is PosEncType.SPATIAL and cfg.pos_dim > 0:
        return SpatialEncoding(cfg.pos_dim)
    if cfg.pos_enc is PosEncType.SINUSOID:
        return SinusoidPositionEncoder(enc_dim=d)
    if cfg.pos_enc is PosEncType.IPE:
        return SinusoidPositionEncoder(enc_dim=d, integrated=True)
    if cfg.pos_enc is PosEncType.LEARN:
        return LearnedPositionEncoder(hidden_dims=d, enc_dims=d)
    if cfg.pos_enc is PosEncType.DPB:
        return DpbPositionEncoder(hidden_dims=d, enc_dims=d)
    return None


def decoder_input_dim(cfg: LiifConfig, channel_list: Sequence[int]) -> int:
    """Input width of the decoder MLP for latents of these channel counts."""
    n = len(channel_list)
    extra = isu_extra_channels(cfg)
    dim = extra * n if cfg.isu_mode is IsuMode.ONLY_ISU else sum(channel_list) + extra * n
    if cfg.quarter_nearest == "both":
        dim *= 4  # the four corner latents, concatenated
    if cfg.pos_enc is PosEncType.NONE or (cfg.pos_enc is PosEncType.SPATIAL and cfg.pos_dim == 0):
        pos = 2  # the raw relative coordinate
    elif cfg.pos_enc is PosEncType.SPATIAL:
        pos = cfg.pos_dim + 2
    else:
        pos = 8  # sinusoid / learn / dpb / ipe project to 8 channels
    dim += pos * n
    if cfg.decode_cell:
        dim += 2 * n
    return dim


def _cell_centers(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Normalized centers of the latent cells `idx` along an axis of n."""
    return -1.0 + (2.0 * idx + 1.0) / n


class LiifDecoder(FlaxNamed):
    """Tap logits (softmax is the caller's) from the latents `feats`
    [B,h_i,w_i,C_i]: at scattered queries `coords` [B, Q, 2] → [B, Q, taps],
    or densely at the axis grids ys [H'], xs [W'] → [B, H', W', taps]."""

    def __init__(self, cfg: LiifConfig, channels: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.imnet = Mlp(decoder_input_dim(cfg, channels), cfg.mlp_hidden, cfg.taps, dtype)
        self.posencs = tuple(make_posenc(cfg) for _ in channels)
        for i, enc in enumerate(self.posencs):
            if enc is not None:
                self.add_module(f"posenc_{i}", enc)

    def forward(self, feats: List[torch.Tensor], ys: Optional[torch.Tensor] = None,
                xs: Optional[torch.Tensor] = None, scale: Optional[torch.Tensor] = None,
                coords: Optional[torch.Tensor] = None) -> torch.Tensor:
        feats = [structure_feature(f, self.cfg) for f in feats]
        dense = coords is None
        grid = (ys, xs) if dense else coords
        build = self._build_latent_dense if dense else self._build_latent
        if not self.cfg.local_ensemble:
            return self.imnet(build(feats, grid, grid, scale)[0])
        # 4-neighbor local ensemble: decode at each diagonal neighbor cell of
        # the first latent and blend by the areas of the opposite cells
        preds, areas = [], []
        for dy, dx in quarter_shifts(spatial.frame_rows(feats[0].shape[1]), feats[0].shape[2]):
            shifted = (ys + dy, xs + dx) if dense else coords + coords.new_tensor((dy, dx))
            latent, (rel_y, rel_x) = build(feats, shifted, grid, scale)
            preds.append(self.imnet(latent))
            area = rel_y[:, None] * rel_x[None, :] if dense else rel_y * rel_x
            areas.append(area.abs() + 1e-9)  # dense: [H', W']; queries: [B, Q]
        tot = areas[0] + areas[1] + areas[2] + areas[3]
        out = 0.0
        for pred, area in zip(preds, reversed(areas)):  # the diagonal areas swap
            out = out + pred * (area / tot)[..., None].to(pred.dtype)
        return out

    def _encode(self, i: int, rel: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
        """The positional encoding of latent i's relative coordinate."""
        enc = self.posencs[i]
        if enc is None:
            return rel
        if getattr(enc, "integrated", False):
            return enc(rel.expand(*cell.shape[:-1], 2), cell)
        return enc(rel)

    def _build_latent(self, feats, sample_coords, rel_coords, scale):
        """Latent [B, Q, C] and the first latent's relative coordinate as
        (y, x), each [B, Q]: per feat, the latent vector of the cell the
        (clamped) sample coordinate lands in (or, in the 4-nearest mode, of
        the four cells at ± half a cell, concatenated) and the offset of
        `rel_coords` from that cell's center (the center of the four) in
        latent-pixel units."""
        b, q, _ = sample_coords.shape
        cell = None if scale is None else (2.0 / scale).reshape(b, 1, 1).expand(b, q, 2)
        pieces, rel0 = [], None
        for i, feat in enumerate(feats):
            fh, fw = spatial.frame_rows(feat.shape[1]), feat.shape[2]
            if self.cfg.quarter_nearest == "both":
                cls = [_clamp_coords(sample_coords + sample_coords.new_tensor(shift))
                       for shift in quarter_shifts(fh, fw)]
                q_feat = torch.cat([nearest_sample(feat, cl) for cl in cls], dim=-1)
                q_coord = 0.5 * (nearest_latent_coords(cls[0], fh, fw)
                                 + nearest_latent_coords(cls[3], fh, fw))
            else:
                cl = _clamp_coords(sample_coords)
                q_feat = nearest_sample(feat, cl)  # [B, Q, C_i]
                q_coord = nearest_latent_coords(cl, fh, fw)  # [B, Q, 2]
            d = rel_coords - q_coord
            rel = torch.stack([d[..., 0] * fh, d[..., 1] * fw], dim=-1)
            if rel0 is None:
                rel0 = (rel[..., 0], rel[..., 1])
            piece = [q_feat, self._encode(i, rel, cell).to(q_feat.dtype)]
            if self.cfg.decode_cell:
                piece.append(cell.to(q_feat.dtype))
            pieces.append(torch.cat(piece, dim=-1))
        return torch.cat(pieces, dim=-1), rel0

    def _build_latent_dense(self, feats, sample_grids, rel_grids, scale):
        """The same over separable grids (ys [H'], xs [W']): latent
        [B, H', W', C] and the first latent's relative coordinate per axis,
        ([H'], [W'])."""
        (sy, sx), (gy, gx) = sample_grids, rel_grids
        oh, ow = sy.shape[0], sx.shape[0]
        b = feats[0].shape[0]
        cell = None if scale is None else (2.0 / scale).reshape(b, 1, 1, 1).expand(b, oh, ow, 2)
        pieces, rel0 = [], None
        for i, feat in enumerate(feats):
            fh, fw = spatial.frame_rows(feat.shape[1]), feat.shape[2]
            if self.cfg.quarter_nearest == "both":
                corners = [nearest_dense_gather(feat, sy + dy, sx + dx)
                           for dy, dx in quarter_shifts(fh, fw)]
                q_feat = torch.cat([c[0] for c in corners], dim=-1)  # [B, H', W', 4C]
                # the 2x2 cell's center: the mean of the (-,-) and (+,+) corners
                qc_y = 0.5 * (_cell_centers(corners[0][1], fh) + _cell_centers(corners[3][1], fh))
                qc_x = 0.5 * (_cell_centers(corners[0][2], fw) + _cell_centers(corners[3][2], fw))
            else:
                q_feat, iy, ix = nearest_dense_gather(feat, sy, sx)
                qc_y, qc_x = _cell_centers(iy, fh), _cell_centers(ix, fw)
            rel_y = (gy - qc_y) * fh
            rel_x = (gx - qc_x) * fw
            if rel0 is None:
                rel0 = (rel_y, rel_x)
            rel = torch.stack([rel_y[:, None].expand(oh, ow), rel_x[None, :].expand(oh, ow)], dim=-1)
            rel = self._encode(i, rel, cell).to(q_feat.dtype)
            piece = [q_feat, rel.expand(b, oh, ow, rel.shape[-1])]
            if self.cfg.decode_cell:
                piece.append(cell.to(q_feat.dtype))
            pieces.append(torch.cat(piece, dim=-1))
        return torch.cat(pieces, dim=-1), rel0
