"""Build and load the port's CUDA sources.

Each `anystereo_tpu_torch/csrc/<name>.cu` is compiled by `nvcc` for Hopper
(`sm_90a`) into a shared library with a plain C interface, which is loaded
with `ctypes`.  Libraries go to `build/kernels/` beside the package, keyed
by a digest of the source, the shared headers (`csrc/*.cuh`) and the flags,
so an edited source or header is rebuilt and an unchanged one is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes()
    text += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: every `csrc/*.cu`) that are not
    built yet, one `nvcc` process per source, all started together.
    Returns the wall seconds each build took; raises on any failure."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    seconds = {}
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        seconds[name] = time.perf_counter() - t0
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
