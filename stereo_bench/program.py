"""The system under test, `anystereo_tpu_torch`, as the benchmark drives it:
its model built from a configuration file, the seeded weights loaded into
it, its eval step, its kernel build, its kernels' launch counters, and the
lookup faults the calibration plants in it.  The only module of the
benchmark that imports the program."""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import os
from typing import Dict

import torch

from anystereo_tpu_torch.config import ModelConfig
from anystereo_tpu_torch.nn.model import AnyStereo
from anystereo_tpu_torch.ops import lookup as ops_lookup
from anystereo_tpu_torch.ops.kernels import lookup as lookup_kernels
from anystereo_tpu_torch.train.step import make_eval_step  # noqa: F401 (the generators call it)


def _fill(cls, values: dict):
    """A config dataclass from JSON values: enums from their strings,
    nested dataclasses from objects, tuples from lists."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            continue
        v = values[f.name]
        default = f.default if f.default is not dataclasses.MISSING else f.default_factory()
        if isinstance(default, enum.Enum):
            v = type(default)(v)
        elif dataclasses.is_dataclass(default):
            v = _fill(type(default), v)
        elif isinstance(default, tuple):
            v = tuple(v)
        kwargs[f.name] = v
    unknown = set(values) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise KeyError(f"{cls.__name__} has no fields {sorted(unknown)}")
    return cls(**kwargs)


def model_config(config: dict) -> ModelConfig:
    return _fill(ModelConfig, config["model"])


def build_kernels() -> Dict[str, float]:
    """Compile (or find in `build/kernels/`) the program's CUDA sources;
    seconds a source."""
    from anystereo_tpu_torch.ops.kernels.build import build

    return build()


def build_model(config: dict, state_dict: Dict[str, torch.Tensor], device) -> AnyStereo:
    """The program's model of `config` on `device`, its weights `state_dict`
    (every key, strict), in eval mode; the lookup flavour of the
    configuration is set for the process (`ANYSTEREO_LOOKUP_KERNEL`)."""
    os.environ["ANYSTEREO_LOOKUP_KERNEL"] = config["lookup"]
    with torch.device(device):
        model = AnyStereo(model_config(config))
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def launches() -> Dict[str, int]:
    """The launch counter of the kernel the lookup roofline reads (B1
    forward)."""
    return {"lookup_fwd": lookup_kernels.gather_pyramid_aligned.launches}


LOOKUP_FAULTS = ("shift", "level")


@contextlib.contextmanager
def lookup_fault(fault: str):
    """A fault planted in the program's aligned lookup (B1) while inside:
    "shift", every tap read one entry past its position (an off-by-one
    in the kernel's indexing); "level", the coarsest level's taps zeroed
    (a level the kernel leaves unwritten).  For the calibration and the
    tests only: it shows what the check makes of a faulty lookup."""
    real = ops_lookup.gather_pyramid_aligned

    def shifted(vol, x, taps, levels, out_dtype=torch.float32):
        return real(vol, x + 1.0, taps, levels, out_dtype)

    def level_zeroed(vol, x, taps, levels, out_dtype=torch.float32):
        out = real(vol, x, taps, levels, out_dtype).clone()  # [R, levels * taps], level-major
        out[:, (levels - 1) * taps:] = 0
        return out

    ops_lookup.gather_pyramid_aligned = {"shift": shifted, "level": level_zeroed}[fault]
    try:
        yield
    finally:
        ops_lookup.gather_pyramid_aligned = real
