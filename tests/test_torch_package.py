"""The port's package: its version and configuration re-exports are the JAX
package's, and importing it loads no JAX (nor torch: only its own
configuration)."""

import dataclasses
import enum
import os
import subprocess
import sys

import anystereo_tpu
import anystereo_tpu_torch

NAMES = ("AggregationType", "DataConfig", "EvalConfig", "LiifConfig", "ModelConfig", "TrainConfig")


def test_version_and_reexports_match_the_jax_package():
    assert anystereo_tpu_torch.__version__ == anystereo_tpu.__version__
    for name in NAMES:
        mine, theirs = getattr(anystereo_tpu_torch, name), getattr(anystereo_tpu, name)
        assert mine.__name__ == theirs.__name__ and mine.__module__ == "anystereo_tpu_torch.config"
    exported = {n for n in vars(anystereo_tpu) if not n.startswith("_") and n[0].isupper()}
    assert exported == set(NAMES)
    assert {n for n in vars(anystereo_tpu_torch) if not n.startswith("_") and n[0].isupper()} == exported


def _plain(x):
    """A configuration value as builtins: dataclasses as dicts, enums as
    their values."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    return x


def test_config_defaults_match_the_jax_package():
    for name in ("DataConfig", "EvalConfig", "LiifConfig", "ModelConfig", "TrainConfig"):
        assert _plain(getattr(anystereo_tpu_torch, name)()) == _plain(getattr(anystereo_tpu, name)()), name
    assert [m.value for m in anystereo_tpu_torch.AggregationType] == \
        [m.value for m in anystereo_tpu.AggregationType]


def test_importing_the_package_loads_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(anystereo_tpu_torch.__file__)))
    code = ("import sys, anystereo_tpu_torch as p\n"
            "bad = [m for m in ('jax', 'flax', 'optax', 'anystereo_tpu', 'torch') if m in sys.modules]\n"
            "assert not bad, bad\n"
            "print(p.__version__, p.ModelConfig().max_disp)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [anystereo_tpu.__version__, str(anystereo_tpu.ModelConfig().max_disp)]
