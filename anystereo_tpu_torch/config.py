"""Typed model and training configuration for the PyTorch port.

A copy of the JAX package's `anystereo_tpu/config.py`: the model section
(the enums, `LiifConfig`, `ModelConfig`, `raft_config` and
`reference_regime_config`), `TrainConfig`,
`MeshConfig`, `DataConfig`, `EvalConfig` and `Config`, with the same fields,
defaults and validation, so one configuration value means the same model and
schedule in both packages.  The port keeps its own copy rather than
importing the JAX package.

The JAX schedule rewrites (`fuse_gru_gates`, `joint_gru_convs`,
`fast_disp_head`, `fuse_motion_convs`, `batch_lr_matching`) keep the flags
here so configurations round-trip, but the port always computes the plain
conv form: they change the schedule of the TPU program, never the parameter
tree or the math.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class CoreType(str, enum.Enum):
    """Which cost-volume stage the pipeline runs."""

    IGEV = "igev"  # GWC volume + 3D aggregation + regressed init disparity
    RAFT = "raft"  # all-pairs correlation pyramid only, zero-init disparity


class AggregationType(str, enum.Enum):
    """High-frequency stem variant."""

    TYPE1 = "type1"  # PixelUnshuffle stems, IN norm
    TYPE2 = "type2"  # adds a full-res stem_1; 3-input LIIF decoder
    TYPE3 = "type3"  # HighRes_Aggregation (squeeze-excite, IN head)
    TYPE4 = "type4"  # HighRes_Aggregation_LN (LayerNorm2d head)
    TYPE5 = "type5"  # HighRes_Aggregation_LN_GeLU — reference default
    IGEV = "igev_stem"  # strided-conv stems (RAFT core only)
    NONE = "none"  # no stems (RAFT core only)


class NormType(str, enum.Enum):
    """Normalization for conv blocks (FROZEN_BATCH = BatchNorm with fixed
    statistics; INSTANCE and GROUP are stateless)."""

    INSTANCE = "instance"
    GROUP = "group"
    LAYER = "layer"  # LayerNorm2d (channel-wise, per-pixel)
    FROZEN_BATCH = "frozen_batch"
    NONE = "none"


class IsuMode(str, enum.Enum):
    """Intra-scale similarity unfolding mode for the LIIF decoder."""

    NONE = "none"
    WITH_ISU = "with_isu"  # affinity on live features, concat
    WITH_V2_ISU = "with_v2_isu"  # affinity on detached features — default
    ONLY_ISU = "only_isu"  # affinity replaces features
    WITH_3V2_ISU = "with_3v2_isu"  # 3 dilations, detached, concat


class PosEncType(str, enum.Enum):
    NONE = "none"
    SPATIAL = "spatial"
    SINUSOID = "sinusoid"
    LEARN = "learn"
    DPB = "dpb"
    IPE = "ipe"


@dataclasses.dataclass(frozen=True)
class LiifConfig:
    """Implicit (LIIF) arbitrary-scale decoder configuration."""

    mlp_hidden: Tuple[int, ...] = (128, 64, 64)
    isu_mode: IsuMode = IsuMode.WITH_V2_ISU
    isu_window: Tuple[int, int] = (3, 3)  # (win_h, win_w) → 8 affinity channels
    isu_dilations: Tuple[int, ...] = (1, 2, 4, 8)
    pos_enc: PosEncType = PosEncType.NONE
    pos_dim: int = 0
    decode_cell: bool = False
    local_ensemble: bool = False
    # 'none' | 'only_disp' | 'both' (4-nearest-tap variants)
    quarter_nearest: str = "none"
    taps: int = 9  # 3x3 neighborhood weights produced by the MLP
    # 'none' | 'width' | 'width1024'
    disparity_norm: str = "none"

    def __post_init__(self):
        object.__setattr__(self, "pos_enc", PosEncType(self.pos_enc))
        if self.quarter_nearest is True:  # legacy bool spelling
            object.__setattr__(self, "quarter_nearest", "only_disp")
        elif self.quarter_nearest is False or self.quarter_nearest is None:
            object.__setattr__(self, "quarter_nearest", "none")
        if self.quarter_nearest not in ("none", "only_disp", "both"):
            raise ValueError(f"quarter_nearest: {self.quarter_nearest!r}")
        if self.quarter_nearest != "none":
            object.__setattr__(self, "taps", 4)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture config (defaults: IGEV core, type5 stems, 3 GRU levels,
    max_disp 192, bf16 compute with fp32 params)."""

    core: CoreType = CoreType.IGEV
    max_disp: int = 192  # full-res; cost volume depth = max_disp // 4
    corr_levels: int = 2
    corr_radius: int = 4
    n_gru_layers: int = 3
    hidden_dims: Tuple[int, int, int] = (128, 128, 128)  # 1/4, 1/8, 1/16
    n_downsample: int = 2  # disparity at 1/2^n resolution
    agg_type: AggregationType = AggregationType.TYPE5
    slow_fast_gru: bool = False
    gru_type: str = "conv"  # "conv" | "sep"
    # schedule rewrites of the JAX package: accepted, computed as plain convs
    fuse_gru_gates: bool = False
    fast_disp_head: bool = True
    fuse_motion_convs: bool = True
    # feed the lookup to the motion encoder as split (geo, corr) parts in
    # the compute dtype; convc1's kernel is sliced per part
    split_lookup_concat: bool = True
    joint_gru_convs: bool = True
    batch_lr_matching: bool = False
    gwc_groups: int = 8
    fnet_dim: int = 256  # RAFT matching-feature dim
    liif: LiifConfig = dataclasses.field(default_factory=LiifConfig)
    norm_2d: NormType = NormType.GROUP
    norm_3d: NormType = NormType.INSTANCE
    # precision policy: bf16 compute, fp32 params, fp32 lookup/regression
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = False

    @property
    def volume_disp(self) -> int:
        return self.max_disp // 4

    @property
    def lookup_channels(self) -> int:
        """Per-pixel lookup width fed to the motion encoder."""
        taps = 2 * self.corr_radius + 1
        if self.core is CoreType.IGEV:
            return self.corr_levels * taps * (self.gwc_groups + 1)
        return self.corr_levels * taps

    def __post_init__(self):
        if self.max_disp % 4 != 0:
            raise ValueError("max_disp must be divisible by 4")
        if self.core is CoreType.IGEV and self.agg_type in (
            AggregationType.IGEV,
            AggregationType.NONE,
        ):
            raise ValueError(f"agg_type {self.agg_type} is RAFT-core only")
        if self.n_gru_layers not in (1, 2, 3):
            raise ValueError("n_gru_layers must be 1, 2, or 3")
        if self.gru_type not in ("conv", "sep"):
            raise ValueError("gru_type must be 'conv' or 'sep'")
        if self.n_downsample != 2 and not (
            self.core is CoreType.RAFT
            and self.agg_type is AggregationType.NONE
        ):
            raise ValueError(
                "n_downsample != 2 requires core=RAFT with agg_type=NONE "
                "(stems and the IGEV pyramid are fixed at 1/4 resolution)"
            )


def raft_config(**overrides) -> ModelConfig:
    """RAFT-core preset (corr_levels 4)."""
    base = dict(
        core=CoreType.RAFT,
        corr_levels=4,
        agg_type=AggregationType.TYPE5,
    )
    base.update(overrides)
    return ModelConfig(**base)


def reference_regime_config(**overrides) -> ModelConfig:
    """The reference's training regime: frozen BatchNorm statistics wherever
    the reference has BatchNorm2d/3d (it freezes every BatchNorm for the
    whole run, the hourglass's BatchNorm3d included).  Use with weights
    imported from a reference checkpoint through `utils.torch_convert`,
    which fills the statistics.  From-scratch training should prefer the
    default GroupNorm regime."""
    base = dict(
        norm_2d=NormType.FROZEN_BATCH,
        norm_3d=NormType.FROZEN_BATCH,
    )
    base.update(overrides)
    return ModelConfig(**base)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule (the JAX package's `TrainConfig`, field for
    field)."""

    lr: float = 2e-4
    weight_decay: float = 1e-5
    num_steps: int = 100_000
    warmup_frac: float = 0.01  # OneCycle pct_start
    batch_size: int = 2
    crop_size: Tuple[int, int] = (320, 736)
    train_iters: int = 16
    valid_iters: int = 32
    grad_clip: float = 1.0
    # a workaround of the JAX package for one TPU runtime (two compiled
    # programs per step); accepted so configurations round-trip, ignored
    split_opt_step: Optional[bool] = None
    # skip (no-op) any update whose grads contain inf/NaN
    skip_nonfinite: bool = True
    # a trainer aborts after this many CONSECUTIVE skipped steps
    max_consecutive_nonfinite: int = 50
    loss_gamma: float = 0.9  # sequence-loss base, exponent 15/(N-1)
    supervise_init: bool = False  # add smooth-L1 on the regressed init disparity
    max_disp_loss: float = 700.0  # GT validity ceiling in the loss
    # arbitrary-scale sampling
    multi_scale: bool = True
    inp_size: Tuple[int, int] = (160, 320)  # low-res input crop
    scale_min: float = 1.0
    scale_max: float = 2.95
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 10_000
    seed: int = 1234

    @property
    def sample_q(self) -> int:
        """Static per-sample query count."""
        return self.inp_size[0] * self.inp_size[1]


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Process layout: `data` = ranks that each take their slice of the
    batch (0: every rank of the process group), `spatial` = ranks that tile
    the images' rows for inference (`parallel/spatial.py`; `train()` refuses
    it)."""

    data: int = 1
    spatial: int = 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset selection and augmentation."""

    train_datasets: Tuple[str, ...] = ("sceneflow",)
    root: str = "/datasets"
    num_workers: int = 8
    # photometric
    saturation_range: Tuple[float, float] = (0.0, 1.4)
    img_gamma: Optional[Tuple[float, float]] = None
    # spatial
    spatial_scale: Tuple[float, float] = (-0.2, 0.4)
    do_flip: Optional[str] = None  # 'h' | 'v' | None
    yjitter: bool = True
    eraser_prob: float = 0.5


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    dataset: str = "sceneflow"
    valid_iters: int = 32
    scale_test: float = 1.0  # arbitrary-scale factor (inputs downscaled by it)
    divis_by: int = 32
    max_disp_metric: float = 1000.0  # validity ceiling of the metrics


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
