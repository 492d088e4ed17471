from anystereo_tpu_torch.nn.layers import (  # noqa: F401
    ConvNormAct,
    Conv2x,
    LayerNorm2d,
    FrozenBatchNorm,
    instance_norm,
    pixel_unshuffle,
)
from anystereo_tpu_torch.nn.extractor import (  # noqa: F401
    BasicEncoder,
    FeaturePyramid,
    MultiBasicEncoder,
)
from anystereo_tpu_torch.nn.stems import StemBranch, stem_channels  # noqa: F401
from anystereo_tpu_torch.nn.aggregation import CostAggregation, FeatureAtt  # noqa: F401
from anystereo_tpu_torch.nn.update import BasicMultiUpdateBlock  # noqa: F401
from anystereo_tpu_torch.nn.liif import LiifDecoder  # noqa: F401
from anystereo_tpu_torch.nn.model import AnyStereo, StereoOutput, MODELS  # noqa: F401
