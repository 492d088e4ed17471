"""anystereo_tpu_torch — the PyTorch/CUDA port of `anystereo_tpu` for one
NVIDIA H100.

The same system as the JAX package (iterative stereo matching with the IGEV
and RAFT cores, the LIIF decoder for disparity at any output scale,
training, evaluation, the CLI), in PyTorch, with a hand-written CUDA kernel
for `sm_90a` in place of each Pallas kernel and the data path's host code
in the port's own C.  Layout: feature maps of shape [B, C, H, W], as
PyTorch's convolutions take them, contiguous in the encoders and the
decoder and channels-last in memory through the GRU loop (the layout
cuDNN's bf16 convolutions read without a transpose); the configuration
values mean what they mean in the JAX package
(`config.py` is the port's own copy).  Importing the package loads its
configuration only: no torch, and nothing of the JAX package.
"""

__version__ = "0.1.0"

from anystereo_tpu_torch.config import (  # noqa: F401
    AggregationType,
    DataConfig,
    EvalConfig,
    LiifConfig,
    ModelConfig,
    TrainConfig,
)
