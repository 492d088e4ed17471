"""The data path's host C and its plain versions.

The resizes (`utils/resize.py`, over `csrc/resize.c`), the augmentor's
colour conversions (`data/augment.py`, over `csrc/colour.c`), the PFM reader
and the sparse rescale (`data/native_io.py`, over `csrc/native_io.c`) each
have two versions: the port's C, built at first use by the host C compiler
(`ops/kernels/build.py`; no fallback: a missing compiler raises
`RuntimeError`), and the plain numpy version, which gives the same arrays
bit for bit.  A function's `impl` argument picks one, "c" or "numpy"; left
None it takes the process's default, the C, which a `plain()` block turns
to numpy for all of them at once (so a whole sample can be made on either
path).  The image readers' C (`data/png.py`, `data/jpeg.py`) is bound here
too.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Sequence

IMPLS = ("c", "numpy")
P, I64, F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double

_PLAIN = False


@contextlib.contextmanager
def plain():
    """The plain numpy versions as the default inside the block, for every
    caller that leaves `impl` None (this process, all its threads)."""
    global _PLAIN
    old, _PLAIN = _PLAIN, True
    try:
        yield
    finally:
        _PLAIN = old


def resolve(impl: Optional[str], what: str) -> str:
    """`impl`, or the default where it is None; raises on any other name."""
    if impl is None:
        return "numpy" if _PLAIN else "c"
    if impl not in IMPLS:
        raise ValueError(f"{what}: impl {impl!r} is not one of {list(IMPLS)}")
    return impl


def function(source: str, name: str, argtypes: Sequence, restype=None):
    """`name` of the library built from `csrc/<source>.c` (built and loaded
    at first use), with its argument and result types set."""
    from anystereo_tpu_torch.ops.kernels import build

    fn = getattr(build.load_library(source), name)
    if fn.argtypes is None:
        fn.restype = restype  # before argtypes, which another thread may read as "set"
        fn.argtypes = list(argtypes)
    return fn
