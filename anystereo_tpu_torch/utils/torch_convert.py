"""Reference-checkpoint import: a trained Any-Stereo `state_dict`
(`continuous_IGEVStereo` or `continuous_RaftStereo`, as the reference's
training scripts save it) → the port's `state_dict`.

The port's own numpy copy of the JAX package's converter
(`anystereo_tpu/utils/torch_convert.py`).  It builds the flax-path tree
`{"params": ..., "batch_stats": ...}` tensor for tensor as the JAX converter
does, and `utils.weights.from_flax` turns that tree into the port's
`state_dict` (its modules carry the flax names; FrozenBatchNorm statistics
become `running_mean` / `running_var`).  The target model is built with
`config.reference_regime_config` (FrozenBatchNorm wherever the reference has
BatchNorm).

Rules kept from the JAX converter:
  * a `module.` prefix (DataParallel) is stripped;
  * `num_batches_tracked`, the `norm3` alias of `downsample.1` and the dead
    `bn` of `BasicConv(bn=False)` are consumed and dropped;
  * the bias that the reference's `conv1_up` lacks is zero-filled (8);
  * the `classifier` has no bias;
  * `_MBV2_MAP` maps the timm mobilenetv2_100 trunk;
  * for IGEV the `convc1` input channels are gathered into the port's lookup
    order through `internal_to_reference_perm` (RAFT's orders agree);
  * a tensor left unconverted raises `ValueError`, a missing one `KeyError`.

The update block is converted for three GRU levels (`gru04`, `gru08`,
`gru16`), as the reference has them: the configuration must have
`n_gru_layers == 3`, else `ValueError`.

Layout rules are in `utils/torch_compat.py`; the flax-side names follow
flax's call-order auto-numbering, which the port's modules copy.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from anystereo_tpu_torch.config import CoreType, ModelConfig
from anystereo_tpu_torch.ops.lookup import internal_to_reference_perm
from anystereo_tpu_torch.utils.torch_compat import (
    conv_kernel,
    conv_transpose_kernel,
    dense_kernel,
    strip_module_prefix,
)
from anystereo_tpu_torch.utils.weights import from_flax


def _put(tree: dict, path: str, value: np.ndarray):
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = np.asarray(value)


class _Converter:
    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = {k: np.asarray(v) for k, v in sd.items()}
        self.params: dict = {}
        self.stats: dict = {}
        self.used: set = set()

    def _get(self, key: str) -> np.ndarray:
        self.used.add(key)
        return self.sd[key]

    # -- primitives ---------------------------------------------------- #

    def conv(self, dst: str, src: str, bias: bool | None = None):
        """torch Conv2d/3d `src.{weight,bias}` → flax `dst/{kernel,bias}`."""
        _put(self.params, f"{dst}/kernel", conv_kernel(self._get(f"{src}.weight")))
        has_bias = f"{src}.bias" in self.sd if bias is None else bias
        if has_bias:
            _put(self.params, f"{dst}/bias", self._get(f"{src}.bias"))

    def deconv(self, dst: str, src: str, zero_bias_features: int | None = None):
        """torch ConvTranspose → TorchConvTranspose kernel (no flip here —
        the flax module flips internally)."""
        _put(
            self.params,
            f"{dst}/kernel",
            conv_transpose_kernel(self._get(f"{src}.weight")),
        )
        if f"{src}.bias" in self.sd:
            _put(self.params, f"{dst}/bias", self._get(f"{src}.bias"))
        elif zero_bias_features is not None:
            # flax side has a bias the torch side lacks (final GEV deconv,
            # BasicConv bn=False built with bias=False)
            _put(self.params, f"{dst}/bias", np.zeros((zero_bias_features,), np.float32))

    def bn(self, dst: str, src: str):
        """BatchNorm → FrozenBatchNorm params + batch_stats."""
        _put(self.params, f"{dst}/scale", self._get(f"{src}.weight"))
        _put(self.params, f"{dst}/bias", self._get(f"{src}.bias"))
        _put(self.stats, f"{dst}/mean", self._get(f"{src}.running_mean"))
        _put(self.stats, f"{dst}/var", self._get(f"{src}.running_var"))
        self.used.add(f"{src}.num_batches_tracked")

    def layernorm2d(self, dst: str, src: str):
        _put(self.params, f"{dst}/scale", self._get(f"{src}.weight"))
        _put(self.params, f"{dst}/bias", self._get(f"{src}.bias"))

    def dense(self, dst: str, src: str):
        _put(self.params, f"{dst}/kernel", dense_kernel(self._get(f"{src}.weight")))
        _put(self.params, f"{dst}/bias", self._get(f"{src}.bias"))

    # -- composite blocks ---------------------------------------------- #

    def residual_block(self, dst: str, src: str):
        """extractor.ResidualBlock (norm_fn='batch') → flax ResidualBlock."""
        self.conv(f"{dst}/Conv_0", f"{src}.conv1")
        self.conv(f"{dst}/Conv_1", f"{src}.conv2")
        # norm_fn='batch' → BatchNorm keys present; 'instance' → stateless
        # (torch InstanceNorm2d default: no affine, no running stats)
        batch = f"{src}.norm1.weight" in self.sd
        if batch:
            self.bn(f"{dst}/FrozenBatchNorm_0", f"{src}.norm1")
            self.bn(f"{dst}/FrozenBatchNorm_1", f"{src}.norm2")
        if f"{src}.downsample.0.weight" in self.sd:
            self.conv(f"{dst}/Conv_2", f"{src}.downsample.0")
            if batch:
                self.bn(f"{dst}/FrozenBatchNorm_2", f"{src}.downsample.1")
                # torch registers norm3 both standalone and as downsample.1
                # (the same module, extractor.py:24,48-49) — consume aliases
                for suffix in ("weight", "bias", "running_mean", "running_var",
                               "num_batches_tracked"):
                    self.used.add(f"{src}.norm3.{suffix}")

    def basic_conv3d(self, dst: str, src: str, bn: bool = True):
        """submodule.BasicConv(is_3d=True) → _Conv3dBlock (ConvNormAct)."""
        self.conv(f"{dst}/ConvNormAct_0/Conv_0", f"{src}.conv")
        if bn:
            self.bn(f"{dst}/ConvNormAct_0/FrozenBatchNorm_0", f"{src}.bn")

    def basic_deconv3d(self, dst: str, src: str, bn: bool = True, features=None):
        self.deconv(
            f"{dst}/ConvNormAct_0/TorchConvTranspose_0",
            f"{src}.conv",
            zero_bias_features=None if bn else features,
        )
        if bn:
            self.bn(f"{dst}/ConvNormAct_0/FrozenBatchNorm_0", f"{src}.bn")
        else:
            # BasicConv instantiates self.bn even with bn=False
            # (submodule.py:8-24) — dead parameters, consume and drop
            for suffix in ("weight", "bias", "running_mean", "running_var",
                           "num_batches_tracked"):
                self.used.add(f"{src}.bn.{suffix}")

    def feature_att(self, dst: str, src: str):
        """submodule.FeatureAtt: BasicConv(k1, BN) + Conv2d."""
        self.conv(f"{dst}/ConvNormAct_0/Conv_0", f"{src}.feat_att.0.conv")
        self.bn(f"{dst}/ConvNormAct_0/FrozenBatchNorm_0", f"{src}.feat_att.0.bn")
        self.conv(f"{dst}/Conv_0", f"{src}.feat_att.1")

    def conv2x_in(self, dst: str, src: str):
        """submodule.Conv2x_IN deconv variant → flax Conv2x (IN: no norm params)."""
        self.deconv(f"{dst}/ConvNormAct_0/TorchConvTranspose_0", f"{src}.conv1.conv")
        self.conv(f"{dst}/ConvNormAct_1/Conv_0", f"{src}.conv2.conv")

    def highres_stem(self, dst: str, src: str):
        """submodule.HighRes_Aggregation_LN_GeLU (type5 default)."""
        self.conv(f"{dst}/ConvNormAct_0/Conv_0", f"{src}.embeding.1.conv")
        self.conv(f"{dst}/Conv_0", f"{src}.sca.1")
        self.conv(f"{dst}/Conv_1", f"{src}.head.0")
        self.layernorm2d(f"{dst}/LayerNorm2d_0", f"{src}.head.1")

    def mbv2_block(self, dst: str, src: str, depthwise_separable: bool):
        """timm InvertedResidual / DepthwiseSeparableConv → flax InvertedResidual."""
        if depthwise_separable:
            self.conv(f"{dst}/Conv_0", f"{src}.conv_dw")
            self.bn(f"{dst}/FrozenBatchNorm_0", f"{src}.bn1")
            self.conv(f"{dst}/Conv_1", f"{src}.conv_pw")
            self.bn(f"{dst}/FrozenBatchNorm_1", f"{src}.bn2")
        else:
            self.conv(f"{dst}/Conv_0", f"{src}.conv_pw")
            self.bn(f"{dst}/FrozenBatchNorm_0", f"{src}.bn1")
            self.conv(f"{dst}/Conv_1", f"{src}.conv_dw")
            self.bn(f"{dst}/FrozenBatchNorm_1", f"{src}.bn2")
            self.conv(f"{dst}/Conv_2", f"{src}.conv_pwl")
            self.bn(f"{dst}/FrozenBatchNorm_2", f"{src}.bn3")

    def conv_gru(self, dst: str, src: str):
        for g in ("convz", "convr", "convq"):
            self.conv(f"{dst}/{g}", f"{src}.{g}")


# mbv2 trunk: flax InvertedResidual_i → (torch feature.blockX prefix, DS?)
# stage split follows Feature (extractor.py:332-341): layers = [1,2,3,5,6]
_MBV2_MAP: Tuple[Tuple[int, str], ...] = (
    (0, "block0.0.0"),
    (1, "block1.0.0"),
    (2, "block1.0.1"),
    (3, "block2.0.0"),
    (4, "block2.0.1"),
    (5, "block2.0.2"),
    (6, "block3.0.0"),
    (7, "block3.0.1"),
    (8, "block3.0.2"),
    (9, "block3.0.3"),
    (10, "block3.1.0"),
    (11, "block3.1.1"),
    (12, "block3.1.2"),
    (13, "block4.0.0"),
    (14, "block4.0.1"),
    (15, "block4.0.2"),
)


def _convert_shared_tail(c: _Converter, cfg: ModelConfig):
    """cnet + gate precompute + update block + LIIF MLP — identical module
    names on both reference cores (prune_raft_stereo.py:103-107,220-227)."""
    cn = "cnet"
    c.conv(f"{cn}/Conv_0", "cnet.conv1")
    c.bn(f"{cn}/FrozenBatchNorm_0", "cnet.norm1")
    rb = 0
    for layer in ("layer1", "layer2", "layer3", "layer4", "layer5"):
        for j in (0, 1):
            c.residual_block(f"{cn}/ResidualBlock_{rb}", f"cnet.{layer}.{j}")
            rb += 1
    for lvl, (net_name, inp_name) in (
        ("04", ("net04", "inp04")),
        ("08", ("net08", "inp08")),
    ):
        for hi, hname in ((0, net_name), (1, inp_name)):
            c.residual_block(f"{cn}/{hname}_res", f"cnet.outputs{lvl}.{hi}.0")
            c.conv(f"{cn}/{hname}_conv", f"cnet.outputs{lvl}.{hi}.1")
    c.conv(f"{cn}/net16_conv", "cnet.outputs16.0")
    c.conv(f"{cn}/inp16_conv", "cnet.outputs16.1")

    for i in range(cfg.n_gru_layers):
        c.conv(f"context_zqr_{i}", f"context_zqr_convs.{i}")

    ub = "update_block"
    for g in ("convc1", "convc2", "convd1", "convd2", "conv"):
        c.conv(f"{ub}/encoder/{g}", f"update_block.encoder.{g}")
    # RAFT lookup (no GEV) uses the reference channel order unchanged —
    # internal_to_reference_perm is the identity for groups=None
    for g in ("gru04", "gru08", "gru16"):
        c.conv_gru(f"{ub}/{g}", f"update_block.{g}")
    c.conv(f"{ub}/disp_head/conv1", "update_block.disp_head.conv1")
    c.conv(f"{ub}/disp_head/conv2", "update_block.disp_head.conv2")

    for di in range(len(cfg.liif.mlp_hidden) + 1):
        c.dense(f"liif/imnet/Dense_{di}", f"liif_up.imnet.layers.{2 * di}")


def _raft_tree(sd: Dict[str, np.ndarray], cfg: ModelConfig) -> dict:
    """Reference continuous_RaftStereo state_dict → AnyStereo (RAFT core)
    variables.  fnet is instance-norm (prune_raft_stereo.py:107: norm_fn
    'instance' — no norm parameters); stems/cnet/update/LIIF share the IGEV
    mapping."""
    sd = strip_module_prefix(sd)
    c = _Converter(sd)

    # ---- fnet (BasicEncoder, extractor.py:126-198, instance norm) ------ #
    c.conv("fnet/Conv_0", "fnet.conv1")
    rb = 0
    for layer in ("layer1", "layer2", "layer3"):
        for j in (0, 1):
            c.residual_block(f"fnet/ResidualBlock_{rb}", f"fnet.{layer}.{j}")
            rb += 1
    c.conv("fnet/Conv_1", "fnet.conv2")

    # ---- stems (type5) -------------------------------------------------- #
    c.highres_stem("stems/stem_2", "stem_2")
    c.highres_stem("stems/stem_4", "stem_4")

    _convert_shared_tail(c, cfg)

    unused = set(sd) - c.used
    if unused:
        raise ValueError(f"unconverted reference tensors: {sorted(unused)[:20]}")
    return {"params": c.params, "batch_stats": c.stats}


def _igev_tree(sd: Dict[str, np.ndarray], cfg: ModelConfig) -> dict:
    """Reference continuous_IGEVStereo state_dict → AnyStereo variables
    {'params': ..., 'batch_stats': ...}.

    The flax model must be configured with norm_2d=norm_3d=FROZEN_BATCH and
    agg_type TYPE5 (the reference default).  Tensors the torch model lacks
    (the final GEV deconv's flax bias) are zero-filled."""
    sd = strip_module_prefix(sd)
    c = _Converter(sd)

    # ---- feature pyramid (Feature, extractor.py:327-362) -------------- #
    trunk = "feature/MobileNetV2Trunk_0"
    c.conv(f"{trunk}/Conv_0", "feature.conv_stem")
    c.bn(f"{trunk}/FrozenBatchNorm_0", "feature.bn1")
    for idx, tsrc in _MBV2_MAP:
        c.mbv2_block(f"{trunk}/InvertedResidual_{idx}", f"feature.{tsrc}", idx == 0)
    c.conv2x_in("feature/Conv2x_0", "feature.deconv32_16")
    c.conv2x_in("feature/Conv2x_1", "feature.deconv16_8")
    c.conv2x_in("feature/Conv2x_2", "feature.deconv8_4")
    c.conv("feature/ConvNormAct_0/Conv_0", "feature.conv4.conv")

    # ---- stems (type5, continuous_IGEVstereo.py:133-137) --------------- #
    c.highres_stem("stems/stem_2", "stem_2")
    c.highres_stem("stems/stem_4", "stem_4")

    # ---- matching descriptor head (:159-160) --------------------------- #
    c.conv("conv/Conv_0", "conv.conv")
    c.conv("desc", "desc")

    # ---- cost aggregation (corr_stem → hourglass, :171-176,22-89) ------ #
    ca = "cost_agg"
    c.basic_conv3d(f"{ca}/_Conv3dBlock_0", "corr_stem")
    c.feature_att(f"{ca}/FeatureAtt_0", "corr_feature_att")
    hg = "cost_agg"  # torch prefix
    c.basic_conv3d(f"{ca}/_Conv3dBlock_1", f"{hg}.conv1.0")
    c.basic_conv3d(f"{ca}/_Conv3dBlock_2", f"{hg}.conv1.1")
    c.feature_att(f"{ca}/FeatureAtt_1", f"{hg}.feature_att_8")
    c.basic_conv3d(f"{ca}/_Conv3dBlock_3", f"{hg}.conv2.0")
    c.basic_conv3d(f"{ca}/_Conv3dBlock_4", f"{hg}.conv2.1")
    c.feature_att(f"{ca}/FeatureAtt_2", f"{hg}.feature_att_16")
    c.basic_conv3d(f"{ca}/_Conv3dBlock_5", f"{hg}.conv3.0")
    c.basic_conv3d(f"{ca}/_Conv3dBlock_6", f"{hg}.conv3.1")
    c.feature_att(f"{ca}/FeatureAtt_3", f"{hg}.feature_att_32")
    c.basic_deconv3d(f"{ca}/_Conv3dBlock_7", f"{hg}.conv3_up")
    c.basic_conv3d(f"{ca}/_Conv3dBlock_8", f"{hg}.agg_0.0")
    c.basic_conv3d(f"{ca}/_Conv3dBlock_9", f"{hg}.agg_0.1")
    c.basic_conv3d(f"{ca}/_Conv3dBlock_10", f"{hg}.agg_0.2")
    c.feature_att(f"{ca}/FeatureAtt_4", f"{hg}.feature_att_up_16")
    c.basic_deconv3d(f"{ca}/_Conv3dBlock_11", f"{hg}.conv2_up")
    c.basic_conv3d(f"{ca}/_Conv3dBlock_12", f"{hg}.agg_1.0")
    c.basic_conv3d(f"{ca}/_Conv3dBlock_13", f"{hg}.agg_1.1")
    c.basic_conv3d(f"{ca}/_Conv3dBlock_14", f"{hg}.agg_1.2")
    c.feature_att(f"{ca}/FeatureAtt_5", f"{hg}.feature_att_up_8")
    # conv1_up: BasicConv(bn=False, relu=False) — torch has no bias, flax does
    c.basic_deconv3d(f"{ca}/_Conv3dBlock_15", f"{hg}.conv1_up", bn=False, features=8)
    c.conv("classifier", "classifier", bias=False)

    # ---- context encoder, gates, update block, LIIF MLP ---------------- #
    _convert_shared_tail(c, cfg)
    # lookup channels arrive in the port's internal order (g-major across
    # levels; ops/lookup.py) — gather the reference convc1 input channels
    # into internal positions
    perm = internal_to_reference_perm(cfg.corr_levels, cfg.corr_radius, cfg.gwc_groups)
    k = c.params["update_block"]["encoder"]["convc1"]["kernel"]
    c.params["update_block"]["encoder"]["convc1"]["kernel"] = k[:, :, perm, :]

    unused = set(sd) - c.used
    if unused:
        raise ValueError(f"unconverted reference tensors: {sorted(unused)[:20]}")
    return {"params": c.params, "batch_stats": c.stats}


def _numpy_state_dict(sd: Mapping) -> Dict[str, np.ndarray]:
    """Numpy arrays from a state_dict of tensors (or arrays); a
    `{"model": state_dict}` checkpoint is unwrapped."""
    if "model" in sd and isinstance(sd["model"], Mapping):
        sd = sd["model"]
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in sd.items()}


def convert_state_dict(sd: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Reference state_dict (tensors or arrays; a `{"model": ...}` checkpoint
    is unwrapped) → the port's state_dict for `AnyStereo(cfg)`: a
    `continuous_IGEVStereo` one for the IGEV core, a `continuous_RaftStereo`
    one for RAFT.  `cfg` comes from `reference_regime_config` (type5 stems;
    IGEV with 2 lookup levels, RAFT with 4) and has `n_gru_layers == 3`."""
    if cfg.n_gru_layers != 3:
        raise ValueError(f"reference checkpoints have three GRU levels (gru04, gru08, gru16); "
                         f"n_gru_layers is {cfg.n_gru_layers}")
    tree = _igev_tree if cfg.core is CoreType.IGEV else _raft_tree
    return from_flax(tree(_numpy_state_dict(sd), cfg))
