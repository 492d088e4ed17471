"""JPEG decode in the port's own C, `csrc/jpeg_decode.c`, built at first use
by the host C compiler into `build/kernels/` (`ops/kernels/build.py`; no
fallback: a missing compiler raises).

`read_jpeg` gives the array the JAX package's reader gives,
`np.array(PIL.Image.open(path))` on libjpeg-turbo with its default
decompression parameters: [H, W] uint8 for gray, [H, W, 3] RGB, [H, W, 4]
CMYK, bit for bit (the integer "islow" IDCT, fancy upsampling or, for
ratios other than 2, box upsampling; libjpeg's fixed-point YCbCr to RGB and
YCCK to CMYK; CMYK inverted, as PIL takes Adobe's convention).  It reads
baseline, extended sequential and progressive Huffman files (SOF0, SOF1,
SOF2) of 8-bit samples with 1, 3 or 4 components, any sampling factors
libjpeg upsamples (1-4, whole ratios, at most 10 blocks an MCU), with
restart intervals.  Arithmetic coding (SOF9-SOF11), lossless (SOF3),
hierarchical, 12-bit files and a progressive file whose scans leave AC
coefficients 1-9 unfinished (libjpeg smooths its blocks) raise
`NotImplementedError`, and corrupt or truncated data `ValueError`, naming
the file and the marker.  The C code keeps no global state and its calls
release the GIL, so the loader's threads decode at once.
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
        out = np.empty((h, w, c) if c > 1 else (h, w), np.uint8)
        rc = _fn("jpeg_decode")(data, len(data), out.ctypes.data, out.nbytes, msg, len(msg))
    if rc:
        raise _ERRORS.get(rc, ValueError)(f"{name}: {msg.value.decode(errors='replace')}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    """Decode the JPEG file at `path` (see the module docstring)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
