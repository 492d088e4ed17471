"""Baseline JPEG decode in the port's own C, `csrc/jpeg_decode.c`, built at
first use by the host C compiler into `build/kernels/`
(`ops/kernels/build.py`; no fallback: a missing compiler raises).

`read_jpeg` gives the array the JAX package's reader gives,
`np.array(PIL.Image.open(path))` on libjpeg-turbo with its default
decompression parameters: [H, W] uint8 for gray, [H, W, 3] RGB, bit for bit
(the integer "islow" IDCT, fancy upsampling, libjpeg's fixed-point YCbCr to
RGB).  It reads baseline and extended sequential Huffman files (SOF0,
SOF1) of 8-bit samples with 1 or 3 components, chroma subsampled 4:4:4,
4:2:2, 4:2:0 or 4:4:0, with restart intervals; anything else
(progressive, arithmetic coding, lossless, 12-bit, 4 components, other
sampling factors) raises `NotImplementedError`, and corrupt or truncated
data `ValueError`, naming the file.  The C code keeps no global state and
its calls release the GIL, so the loader's threads decode at once.
"""

from __future__ import annotations

import ctypes

import numpy as np

from anystereo_tpu_torch.utils import host_c

_ERRORS = {1: ValueError, 2: NotImplementedError, 3: MemoryError}


def _fn(name: str):
    c_char_p, i64 = ctypes.c_char_p, ctypes.c_int64
    argtypes = {"jpeg_info": [c_char_p, i64, ctypes.POINTER(ctypes.c_int32), c_char_p, i64],
                "jpeg_decode": [c_char_p, i64, ctypes.c_void_p, i64, c_char_p, i64]}[name]
    return host_c.function("jpeg_decode", name, argtypes, ctypes.c_int)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode the JPEG file held in `data`; `name` goes into the errors."""
    msg = ctypes.create_string_buffer(256)
    dims = (ctypes.c_int32 * 3)()
    rc = _fn("jpeg_info")(data, len(data), dims, msg, len(msg))
    if rc == 0:
        h, w, c = dims
        out = np.empty((h, w, c) if c == 3 else (h, w), np.uint8)
        rc = _fn("jpeg_decode")(data, len(data), out.ctypes.data, out.nbytes, msg, len(msg))
    if rc:
        raise _ERRORS.get(rc, ValueError)(f"{name}: {msg.value.decode(errors='replace')}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    """Decode the JPEG file at `path` (see the module docstring)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
