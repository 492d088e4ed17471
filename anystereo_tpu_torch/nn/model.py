"""The Any-Stereo pipeline with the IGEV core, eval and train forward (twin
of `anystereo_tpu/nn/model.py`).

normalize → matching features + stems → GWC volume → 3-D aggregation →
softargmin init disparity → lookup pyramids → context encoder and gate
precompute → `iters` × (pyramid lookup → GRU update) → LIIF decode: once
at the end in eval mode (densely over an output grid, or at scattered
queries), after every iteration at the queries in train mode.

Inputs and outputs keep the JAX package's layout ([B, H, W, 3] images in,
[B, H', W'] or [B, Q] disparity out); the modules run channels-first
inside.  Autograd follows `mode`: the eval forward records no graph, the
train forward does, and its lookups and query gathers are
`torch.autograd.Function`s whose backward is a kernel on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from anystereo_tpu_torch.config import CoreType, ModelConfig, NormType
from anystereo_tpu_torch.nn.aggregation import CostAggregation
from anystereo_tpu_torch.nn.extractor import FeaturePyramid, MultiBasicEncoder
from anystereo_tpu_torch.nn.layers import Conv, ConvNormAct, init_parameters
from anystereo_tpu_torch.nn.liif import LiifDecoder
from anystereo_tpu_torch.nn.stems import StemBranch
from anystereo_tpu_torch.nn.update import BasicMultiUpdateBlock
from anystereo_tpu_torch.ops.coords import _axis_centers, make_coord
from anystereo_tpu_torch.ops.cost_volume import build_gwc_and_corr, disparity_regression
from anystereo_tpu_torch.ops.lookup import build_pyramid, pyramid_lookup
from anystereo_tpu_torch.ops.sampling import nearest_dense_gather
from anystereo_tpu_torch.ops.upsample import context_upsample_queries, unfold3x3
from anystereo_tpu_torch.utils.device import resolve_device


class StereoOutput(NamedTuple):
    """init_disp: [B, H/4, W/4] regressed initial disparity; disp_preds:
    [iters, B, Q] per-iteration decoded predictions (train), None (eval);
    disp_final: [B, Q] (queries) or [B, H', W'] (dense grid) final decoded
    disparity; disp_lowres: [B, H/4, W/4] final pre-upsample disparity."""

    init_disp: Optional[torch.Tensor]
    disp_preds: Optional[torch.Tensor]
    disp_final: torch.Tensor
    disp_lowres: torch.Tensor


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def dense_query_coords(b: int, out_h: int, out_w: int,
                       device: Optional[torch.device] = None) -> torch.Tensor:
    """Full-grid queries for fixed-size decoding ([B, H*W, 2], (y, x))."""
    return make_coord((out_h, out_w), device=device)[None].expand(b, out_h * out_w, 2)


class AnyStereo(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.core is not CoreType.IGEV:
            raise NotImplementedError("the RAFT core is not ported yet")
        self.cfg = cfg
        dt = getattr(torch, cfg.compute_dtype)
        self.dt = dt
        hd = cfg.hidden_dims
        self.feature = FeaturePyramid(norm=cfg.norm_2d, dtype=dt)
        # match-descriptor head over [pyramid 1/4 (48) | stem 1/4 (48)]
        self.conv = ConvNormAct(96, 96, 3, stride=1, padding=1, norm=NormType.INSTANCE, dtype=dt)
        self.desc = Conv(96, 96, 1, dtype=dt)
        self.cost_agg = CostAggregation(cfg.gwc_groups, cfg.norm_3d, cfg.norm_2d, dt)
        self.classifier = Conv(8, 1, 3, 1, 1, bias=False, dims=3, dtype=torch.float32)
        self.stems = StemBranch(cfg.agg_type, dtype=dt)
        self.cnet = MultiBasicEncoder(hd, hd, cfg.n_gru_layers, cfg.n_downsample,
                                      cfg.norm_2d, dt)
        for i in range(cfg.n_gru_layers):
            self.add_module(f"context_zqr_{i}", Conv(hd[2 - i], hd[2 - i] * 3, 3, 1, 1, dtype=dt))
        self.update_block = BasicMultiUpdateBlock(hd, cfg.n_gru_layers, cfg.lookup_channels,
                                                  cfg.gru_type, dt)
        self.liif = LiifDecoder(cfg.liif, (48 + hd[2], 32), dtype=dt)

    # ------------------------------------------------------------------ #

    def _normalize(self, img: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [0, 255] → [B, 3, H, W] in [-1, 1], compute dtype."""
        return (2.0 * (img / 255.0) - 1.0).to(self.dt).permute(0, 3, 1, 2)

    def _matching(self, left, right):
        feats_l = self.feature(left)
        feats_r = self.feature(right)
        s1x, s2x, s4x = self.stems(left)
        _, _, s4y = self.stems(right)
        f4_l = torch.cat([feats_l[0], s4x], dim=1)
        f4_r = torch.cat([feats_r[0], s4y], dim=1)
        match_l = self.desc(self.conv(f4_l))
        match_r = self.desc(self.conv(f4_r))
        return match_l, match_r, [f4_l] + feats_l[1:], (s1x, s2x, s4x)

    def _cost_stage(self, match_l, match_r, feats_l):
        cfg = self.cfg
        d = cfg.volume_disp
        gwc, corr = build_gwc_and_corr(_nhwc(match_l), _nhwc(match_r), d, cfg.gwc_groups)
        vol = gwc.permute(0, 3, 4, 1, 2).to(self.dt)  # [B, G, D, H, W]
        gev = self.cost_agg(vol, feats_l)  # [B, 8, D, H, W]
        logits = self.classifier(gev.float())[:, 0]  # [B, D, H, W] fp32
        prob = torch.softmax(logits, dim=1)
        init_disp = disparity_regression(prob.permute(0, 2, 3, 1), d)
        geo = gev.permute(0, 3, 4, 1, 2)  # [B, H, W, 8, D]
        return build_pyramid(corr, geo, cfg.corr_levels, cfg.corr_radius), init_disp

    def _context(self, left):
        cnet_out = self.cnet(left)
        net = [torch.tanh(n) for n, _ in cnet_out]
        ctx = [
            tuple(getattr(self, f"context_zqr_{i}")(F.relu(inp)).chunk(3, dim=1))
            for i, (_, inp) in enumerate(cnet_out)
        ]
        return net, ctx

    def _gru_update(self, net, disp, pyr, ctx):
        """One refinement step.  The disparity enters detached at all its
        uses (lookup positions, motion encoder input, the carried value):
        an iteration's gradient reaches earlier ones only through the
        hidden state, as in the JAX twin."""
        cfg = self.cfg
        disp = disp.detach()
        if cfg.split_lookup_concat:
            geo = pyramid_lookup(pyr, disp, split=True, out_dtype=self.dt)
        else:
            geo = pyramid_lookup(pyr, disp).to(self.dt)
        n = cfg.n_gru_layers
        if cfg.slow_fast_gru and n == 3:
            net, _ = self.update_block(net, ctx, iter04=False, iter08=False, iter16=True,
                                       update=False)
        if cfg.slow_fast_gru and n >= 2:
            net, _ = self.update_block(net, ctx, iter04=False, iter08=True, iter16=n == 3,
                                       update=False)
        net, delta = self.update_block(net, ctx, corr=geo, disp=disp[:, None].to(self.dt),
                                       iter16=n == 3, iter08=n >= 2)
        return net, disp + delta[:, 0].float()

    def _scale_disp(self, disp, scale):
        up = float(2 ** self.cfg.n_downsample)
        w = disp.shape[-1]
        norm = self.cfg.liif.disparity_norm
        if norm == "width":
            return disp / w
        if norm == "width1024":
            return disp / w * 1024.0
        return disp * up * scale[:, None, None]

    def _denorm_disp(self, disp_up, w, scale):
        up = float(2 ** self.cfg.n_downsample)
        norm = self.cfg.liif.disparity_norm
        factor = torch.round(w * up * scale).reshape(-1, 1, 1)
        if norm == "width":
            return disp_up * factor
        if norm == "width1024":
            return disp_up / 1024.0 * factor
        return disp_up

    def _decoder_feats(self, hidden, stems):
        """The decoder's latents, channels-last: [1/4 stem | hidden state]
        and the 1/2 stem."""
        _, s2x, s4x = stems
        return [_nhwc(torch.cat([s4x, hidden], dim=1)), _nhwc(s2x)]

    def _upsample(self, disp, hidden, stems, coords, scale):
        """Query decode: LIIF weights at `coords` [B, Q, 2] → softmax →
        weighted 3x3 combine of disp * 4 * scale → [B, Q]."""
        feats = self._decoder_feats(hidden, stems)
        weights = torch.softmax(self.liif(feats, coords=coords, scale=scale).float(), dim=-1)
        up = context_upsample_queries(self._scale_disp(disp, scale), weights, coords)
        return self._denorm_disp(up, disp.shape[-1], scale)

    def _upsample_dense(self, disp, hidden, stems, ys, xs, scale):
        feats = self._decoder_feats(hidden, stems)
        weights = torch.softmax(self.liif(feats, ys, xs, scale).float(), dim=-1)
        w0 = disp.shape[-1]
        patches = unfold3x3(self._scale_disp(disp, scale))  # [B, h, w, 9] fp32
        up, _, _ = nearest_dense_gather(patches, ys, xs)  # [B, H', W', 9]
        return self._denorm_disp((up * weights).sum(dim=-1), w0, scale)

    # ------------------------------------------------------------------ #

    def forward(
        self,
        left: torch.Tensor,
        right: torch.Tensor,
        iters: int = 16,
        scale: Optional[Union[float, torch.Tensor]] = None,
        mode: str = "eval",
        dense_grid: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        coords: Optional[torch.Tensor] = None,
    ) -> StereoOutput:
        """left/right: [B, H, W, 3] images in 0..255 on the model's device.
        coords: [B, Q, 2] normalized (y, x) queries (training, scattered
        ground truth).  dense_grid: (ys [H'], xs [W']) separable output
        grid, eval only.  With neither, eval decodes the input's own pixel
        centers densely and train queries them.  scale: [B] arbitrary-scale
        factor (default 1).  mode: "eval" records no autograd graph and
        decodes once; "train" records one and decodes after every
        iteration (`disp_preds`)."""
        if mode not in ("eval", "train"):
            raise ValueError(f"mode must be 'eval' or 'train', got {mode!r}")
        if dense_grid is not None and mode == "train":
            raise ValueError("dense_grid is an eval-only decode path")
        with torch.set_grad_enabled(mode == "train"):
            return self._forward(left, right, iters, scale, mode, dense_grid, coords)

    def _forward(self, left, right, iters, scale, mode, dense_grid, coords):
        b, h, w, _ = left.shape
        dev = left.device
        if scale is None:
            scale = torch.ones((b,), dtype=torch.float32, device=dev)
        else:
            scale = torch.broadcast_to(torch.as_tensor(scale, dtype=torch.float32, device=dev), (b,))
        if coords is None and dense_grid is None:
            if mode == "train":
                coords = dense_query_coords(b, h, w, dev)
            else:
                dense_grid = (_axis_centers(h, device=dev), _axis_centers(w, device=dev))
        left = self._normalize(left)
        right = self._normalize(right)
        match_l, match_r, feats_l, stems = self._matching(left, right)
        pyr, init_disp = self._cost_stage(match_l, match_r, feats_l)
        net, ctx = self._context(left)
        disp = init_disp

        if mode == "train":

            def body(disp, *net):
                net, disp = self._gru_update(list(net), disp, pyr, ctx)
                return (disp, self._upsample(disp, net[0], stems, coords, scale), *net)

            preds = []
            for _ in range(iters):
                if self.cfg.remat:
                    # keep only the carried state per iteration; the body is
                    # run again in the backward pass
                    out = checkpoint(body, disp, *net, use_reentrant=False)
                else:
                    out = body(disp, *net)
                disp, disp_up, net = out[0], out[1], list(out[2:])
                preds.append(disp_up)
            disp_preds = torch.stack(preds)  # [iters, B, Q]
            return StereoOutput(init_disp=init_disp, disp_preds=disp_preds,
                                disp_final=disp_preds[-1], disp_lowres=disp)

        for _ in range(iters):
            net, disp = self._gru_update(net, disp, pyr, ctx)
        if dense_grid is not None:
            ys, xs = dense_grid
            disp_up = self._upsample_dense(disp, net[0], stems, ys, xs, scale)
        else:
            disp_up = self._upsample(disp, net[0], stems, coords, scale)
        return StereoOutput(init_disp=init_disp, disp_preds=None, disp_final=disp_up,
                            disp_lowres=disp)


def build_model(cfg: ModelConfig, device=None, seed: int = 0) -> AnyStereo:
    """AnyStereo with weights drawn from a CPU `torch.Generator` seeded with
    `seed`, in eval mode on `device` (default: the CUDA card; the CPU only
    when asked for by name)."""
    dev = resolve_device(device)
    model = init_parameters(AnyStereo(cfg), seed)
    return model.to(dev).eval()


def _build_igev(device=None, seed: int = 0, **kw) -> AnyStereo:
    return build_model(ModelConfig(**kw), device, seed)


def _build_raft(device=None, seed: int = 0, **kw) -> AnyStereo:
    raise NotImplementedError("the RAFT core is not ported yet")


MODELS = {
    "continuous_IGEVStereo": _build_igev,
    "continuous_RAFTStereo": _build_raft,
}
