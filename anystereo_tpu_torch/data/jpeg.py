"""JPEG decode in the port's own C, `csrc/jpeg_decode.c`, built at first use
by the host C compiler into `build/kernels/` (`ops/kernels/build.py`; no
fallback: a missing compiler raises).

`read_jpeg(path)` gives the array the JAX package's reader gives,
`np.array(PIL.Image.open(path))` on libjpeg-turbo with its default
decompression parameters: [H, W] uint8 for gray, [H, W, 3] RGB, [H, W, 4]
CMYK, bit for bit (the integer "islow" IDCT, fancy upsampling or, for
ratios other than 2 and in lossless files, box upsampling; libjpeg's
fixed-point YCbCr to RGB and YCCK to CMYK; CMYK inverted, as PIL takes
Adobe's convention).  `read_jpeg(path, mode="opencv")` gives the gray
`cv2.imread(path, cv2.IMREAD_ANYDEPTH)` makes (libjpeg's gray output, and
OpenCV's CMYK to gray), unrotated (`data/exif.py` turns it).  It reads
baseline, extended sequential and progressive files coded with Huffman
tables or arithmetically (SOF0-SOF2, SOF9, SOF10), lossless files (SOF3),
8-bit samples with 1, 3 or 4 components, any sampling factors libjpeg
upsamples (1-4, whole ratios, at most 10 blocks an MCU), restart
intervals, and progressive files cut short (libjpeg's block smoothing).
What PIL refuses too (hierarchical and arithmetic-coded lossless files,
other precisions, a lossless file whose colour libjpeg would convert)
raises `NotImplementedError`, and corrupt or truncated data `ValueError`,
naming the file and the marker.  The C code keeps no global state and its
calls release the GIL, so the loader's threads decode at once.
"""

from __future__ import annotations

import ctypes

import numpy as np

from anystereo_tpu_torch.utils import host_c

_ERRORS = {1: ValueError, 2: NotImplementedError, 3: MemoryError}
MODES = ("pil", "opencv")  # the C's output modes 0 and 1


def _fn(name: str):
    c_char_p, i64, i32 = ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32
    argtypes = {"jpeg_info": [c_char_p, i64, ctypes.POINTER(i32), i32, c_char_p, i64],
                "jpeg_decode": [c_char_p, i64, ctypes.c_void_p, i64, i32, c_char_p, i64]}[name]
    return host_c.function("jpeg_decode", name, argtypes, ctypes.c_int)


def decode_jpeg(data: bytes, name: str = "<bytes>", mode: str = "pil") -> np.ndarray:
    """Decode the JPEG file held in `data` into the array of `mode`
    (`MODES`); `name` goes into the errors."""
    if mode not in MODES:
        raise ValueError(f"decode_jpeg: mode {mode!r} is not one of {MODES}")
    code = MODES.index(mode)
    msg = ctypes.create_string_buffer(256)
    dims = (ctypes.c_int32 * 3)()
    rc = _fn("jpeg_info")(data, len(data), dims, code, msg, len(msg))
    if rc == 0:
        h, w, c = dims
        out = np.empty((h, w, c) if c > 1 else (h, w), np.uint8)
        rc = _fn("jpeg_decode")(data, len(data), out.ctypes.data, out.nbytes, code, msg, len(msg))
    if rc:
        raise _ERRORS.get(rc, ValueError)(f"{name}: {msg.value.decode(errors='replace')}")
    return out


def read_jpeg(path: str, mode: str = "pil") -> np.ndarray:
    """Decode the JPEG file at `path` into the array of `mode` (see the
    module docstring)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path, mode)
