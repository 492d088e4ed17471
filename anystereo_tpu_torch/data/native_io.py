"""The data path's native helpers in the port's own C, `csrc/native_io.c`
(twin of `anystereo_tpu/data/native_io.py` over the JAX repo's
`native/anystereo_native.cpp`).

The same functions, argument order, output dtypes and exceptions:
`read_pfm(path)` gives float32 [H, W] or [H, W, 3], top row first;
`scatter_resize_sparse(flow, valid, fx, fy)` gives (float32 [H', W', 2],
int32 [H', W']); `sample_queries(values, coords, idx)` gives (values[idx],
coords[idx]).  The library is built at first use by the host C compiler
into `build/kernels/` and loaded with ctypes (`utils/host_c.py`), so a call
releases the GIL.  There is no fallback: with no compiler every function
raises `RuntimeError` naming the source, and `available()` is False.

The JAX module scales a sparse flow in float32 and its numpy fallback in
double; the two differ in the last bit of some values.  This module gives
the JAX module's by default and the fallback's with `numpy_rules=True`, as
the augmentor asks (its plain version is that fallback).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from anystereo_tpu_torch.utils import host_c

_PFM_ERRORS = {
    1: (FileNotFoundError, "cannot open {path}"),
    2: (ValueError, "{path}: not a PFM file"),
    3: (ValueError, "{path}: malformed PFM header"),
    4: (ValueError, "{path}: missing PFM scale"),
    5: (ValueError, "{path}: implausible PFM dims {w}x{h}"),
    6: (ValueError, "{path}: truncated PFM payload"),
}


def _fn(name: str):
    P, I64, F64 = host_c.P, host_c.I64, host_c.F64
    argtypes, restype = {
        "pfm_header": ([ctypes.c_char_p, P], I64),
        "pfm_payload": ([ctypes.c_char_p, I64, I64, I64, I64, I64, P], I64),
        "scatter_resize_sparse": ([P, P, I64, I64, F64, F64, I64, I64, I64, P, P], None),
        "sample_queries": ([P, P, P, I64, I64, P, P], I64),
    }[name]
    return host_c.function("native_io", name, argtypes, restype)


def available() -> bool:
    """Whether the C library builds (a host C compiler is found) and loads."""
    try:
        _fn("pfm_header")
    except (RuntimeError, OSError):
        return False
    return True


def _check_pfm(status: int, path: str, dims) -> None:
    if status:
        kind, message = _PFM_ERRORS[status]
        raise kind(message.format(path=path, w=dims[1], h=dims[0]))


def read_pfm(path: str) -> np.ndarray:
    """Decode a PFM file to a float32 ndarray (rows flipped top-down)."""
    if not isinstance(path, str):
        raise TypeError(f"read_pfm: argument 1 must be str, not {type(path).__name__}")
    raw = os.fsencode(path)
    if b"\0" in raw:
        raise ValueError("read_pfm: embedded null character in path")
    dims = (ctypes.c_int64 * 5)()
    _check_pfm(_fn("pfm_header")(raw, ctypes.addressof(dims)), path, dims)
    h, w, ch, little, offset = dims
    out = np.empty((h, w, 3) if ch == 3 else (h, w), np.float32)
    _check_pfm(_fn("pfm_payload")(raw, offset, h, w, ch, little, out.ctypes.data), path, dims)
    return out


def _as(a, dtype, what: str) -> np.ndarray:
    """`a` as a C-contiguous array of `dtype`, cast only where numpy's
    "safe" rule allows it (as the JAX module converts its arguments)."""
    if not isinstance(a, np.ndarray):
        raise TypeError(f"{what} must be numpy.ndarray, not {type(a).__name__}")
    if not np.can_cast(a.dtype, dtype, "safe"):
        raise TypeError(f"Cannot cast array data from {a.dtype!r} to {np.dtype(dtype)!r} according to "
                        f"the rule 'safe'")
    return np.ascontiguousarray(a, dtype)


def scatter_resize_sparse(flow: np.ndarray, valid: np.ndarray, fx: float, fy: float, *,
                          numpy_rules: bool = False):
    """Rescale a sparse flow map by scatter; returns (flow', valid').
    flow [H, W, 2] and valid [H, W]: each pixel with valid >= 1 moves to
    (round(x fx), round(y fy)), halves to even, where that lies strictly
    inside the (round(H fy), round(W fx)) map, its flow times (fx, fy).
    `numpy_rules`: the JAX package's numpy fallback's products (module
    docstring) instead of its native module's."""
    flow, valid = _as(flow, np.float32, "argument 1"), _as(valid, np.float32, "argument 2")
    fx, fy = float(fx), float(fy)
    if flow.ndim != 3 or flow.shape[2] != 2 or valid.shape != flow.shape[:2]:
        raise ValueError("flow must be [H,W,2] with valid [H,W] of the same H,W")
    ht, wd = flow.shape[:2]
    ht1, wd1 = int(round(ht * fy)), int(round(wd * fx))
    out_flow = np.zeros((ht1, wd1, 2), np.float32)
    out_valid = np.zeros((ht1, wd1), np.int32)
    _fn("scatter_resize_sparse")(flow.ctypes.data, valid.ctypes.data, ht, wd, fx, fy, ht1, wd1,
                                 bool(numpy_rules), out_flow.ctypes.data, out_valid.ctypes.data)
    return out_flow, out_valid


def sample_queries(values: np.ndarray, coords: np.ndarray, idx: np.ndarray):
    """Gather (values, coords) at int64 indices in one pass: values [N],
    coords [N, 2], idx [Q] -> (float32 [Q], float32 [Q, 2])."""
    values = _as(values, np.float32, "argument 1")
    coords = _as(coords, np.float32, "argument 2")
    idx = _as(idx, np.int64, "argument 3")
    if values.ndim != 1 or coords.ndim != 2 or coords.shape[1] != 2 or idx.ndim != 1 or \
            coords.shape[0] != values.shape[0]:
        raise ValueError("values must be [N], coords [N,2], idx [Q]")
    v_out = np.empty(idx.shape[0], np.float32)
    c_out = np.empty((idx.shape[0], 2), np.float32)
    bad = _fn("sample_queries")(values.ctypes.data, coords.ctypes.data, idx.ctypes.data,
                                values.shape[0], idx.shape[0], v_out.ctypes.data, c_out.ctypes.data)
    if bad >= 0:
        raise IndexError(f"index {int(idx[bad])} out of range")
    return v_out, c_out
