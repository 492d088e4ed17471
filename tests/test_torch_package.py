"""The port's package: its version and configuration re-exports are the JAX
package's, and importing it loads no JAX (nor torch: only its own
configuration).  Its subpackages `nn`, `ops`, `parallel` and `train`
re-export what their JAX twins do, and any of them, or of the leaf modules
that other modules import, can be imported first (each in a fresh
interpreter) without JAX and without building a kernel."""

import dataclasses
import enum
import importlib
import inspect
import json
import os
import subprocess
import sys

import pytest

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


# --------------------------------------------------- the subpackages' exports

SUBPACKAGES = ("nn", "ops", "parallel", "train")
# imported first, each in a fresh interpreter: the subpackages, and the leaf
# modules that other modules of the port import
FIRST = SUBPACKAGES + ("ops.sampling", "ops.upsample", "ops.coords", "parallel.spatial", "nn.model")


def _jax_exports(sub):
    """The names `anystereo_tpu/<sub>/__init__.py` re-exports, read with
    `ast`, less those the surface test records as not ported."""
    import ast

    from test_torch_surface import NOT_PORTED, TABLE

    root = os.path.dirname(os.path.abspath(anystereo_tpu.__file__))
    rel = f"{sub}/__init__.py"
    tree = ast.parse(open(os.path.join(root, rel)).read())
    names = [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom) for a in node.names]
    return [n for n in names if TABLE.get((rel, n), (None,))[0] != NOT_PORTED]


_PROBE = """
import importlib, json, sys
first, exports = sys.argv[1], json.loads(sys.argv[2])
importlib.import_module("anystereo_tpu_torch." + first)
loaded = [m for m in ("jax", "flax", "optax", "anystereo_tpu") if m in sys.modules]
build = sys.modules.get("anystereo_tpu_torch.ops.kernels.build")
built = [] if build is None else sorted(build._LIBS) + sorted(build.BUILD_LOGS)
missing = {sub: [n for n in names if not hasattr(importlib.import_module("anystereo_tpu_torch." + sub), n)]
           for sub, names in exports.items()}
print(json.dumps({"loaded": loaded, "built": built, "missing": missing}))
"""


@pytest.fixture(scope="module")
def first_imports():
    """{module: what the probe saw} for each module of FIRST imported first
    in its own interpreter, all started at once."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(anystereo_tpu_torch.__file__)))
    exports = json.dumps({sub: _jax_exports(sub) for sub in SUBPACKAGES})
    env = {**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1"}
    procs = {m: subprocess.Popen([sys.executable, "-c", _PROBE, m, exports], cwd=root, env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for m in FIRST}
    out = {}
    for m, p in procs.items():
        stdout, stderr = p.communicate(timeout=180)
        out[m] = (p.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("first", FIRST)
def test_subpackages_export_the_jax_names_whatever_is_imported_first(first_imports, first):
    """Importing `first` before anything else of the port works (no import
    cycle), loads no JAX, flax or JAX package and builds no kernel; then each
    of the four subpackages exports every name its JAX twin exports, but
    those the surface test records as not ported."""
    rc, stdout, stderr = first_imports[first]
    assert rc == 0, stderr[-3000:]
    seen = json.loads(stdout.strip().splitlines()[-1])
    assert seen == {"loaded": [], "built": [], "missing": {sub: [] for sub in SUBPACKAGES}}


def test_the_subpackages_export_what_the_jax_twins_do():
    """The JAX twins' names (AST) are the port's exports: the same names,
    each bound to the port's own object, and nothing else exported."""
    for sub in SUBPACKAGES:
        module = importlib.import_module(f"anystereo_tpu_torch.{sub}")
        names = _jax_exports(sub)
        assert names and all(getattr(module, n).__module__.startswith("anystereo_tpu_torch.")
                             for n in names if hasattr(getattr(module, n), "__module__"))
        public = {n for n, v in vars(module).items() if not n.startswith("_") and not inspect.ismodule(v)}
        assert public == set(names), sub
