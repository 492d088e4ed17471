"""Build and load the port's native sources.

Each `anystereo_tpu_torch/csrc/<name>.cu` is compiled by `nvcc` for Hopper
(`sm_90a`) into a shared library with a plain C interface, which is loaded
with `ctypes`.  Each `csrc/<name>.c` is host C (the image readers' PNG
unfilter and JPEG decoder; the augmentor's resizes and colour conversions;
the PFM reader and the sparse rescale), compiled by the host C compiler
(`$CC`, else `cc`, else `gcc`) with `C_FLAGS`, which forbid contracting a
multiply and an add into one rounding, so that the host C gives numpy's
arithmetic bit for bit.  Libraries go to `build/kernels/` beside the
package, keyed by a digest of the source, the shared headers (`csrc/*.cuh`,
for CUDA sources), the compiler's path and the flags, so an edited source
or header is rebuilt and an unchanged one is reused.  A library is loaded
with `ctypes.CDLL`, so its calls release the GIL.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
C_FLAGS = ("-std=c11", "-O2", "-ffp-contract=off", "-fPIC", "-shared")
C_LIBS = ("-lm",)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()  # one build a source at a time in this process (the loader's threads)
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


def _cc(source: Path) -> str:
    """The host C compiler for `source`: `$CC` where it is set, else `cc`,
    else `gcc`."""
    names = [os.environ["CC"]] if os.environ.get("CC") else ["cc", "gcc"]
    for name in names:
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(f"no host C compiler to build {source} (searched {', '.join(names)}; "
                       "set CC to one)")


def _is_c(name: str) -> bool:
    return (CSRC / f"{name}.c").exists()


def library_path(name: str) -> Path:
    if _is_c(name):
        text = (CSRC / f"{name}.c").read_bytes()
        flags = " ".join((_cc(CSRC / f"{name}.c"),) + C_FLAGS + C_LIBS)
    else:
        text = (CSRC / f"{name}.cu").read_bytes()
        text += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        flags = " ".join(NVCC_FLAGS)
    digest = hashlib.sha256(text + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _command(name: str, tmp: Path) -> List[str]:
    if _is_c(name):
        src = CSRC / f"{name}.c"
        return [_cc(src), *C_FLAGS, "-o", str(tmp), str(src), *C_LIBS]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: every `csrc/*.cu`) that are not
    built yet, one compiler process per source, all started together.
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
        # a name of its own for each process, since several may build the
        # same source at once; the rename below is atomic
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = _command(name, tmp)
        procs.append((name, out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    seconds = {}
    for name, out, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed for {cmd[-1]}:\n{log}")
        os.replace(tmp, out)
        seconds[name] = time.perf_counter() - t0
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu` or `csrc/<name>.c`, built on
    first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(library_path(name)))
                _LIBS[name] = lib
    return lib
