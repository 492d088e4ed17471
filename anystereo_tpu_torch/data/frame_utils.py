"""Image and disparity file readers and writers (twin of
`anystereo_tpu/data/frame_utils.py`): PFM, .flo, KITTI's 16-bit PNG
(disparity x 256, 0 = invalid), Sintel's RGB-packed disparity with its
occlusion mask, FallingThings' depth turned into disparity by the camera's
focal length, TartanAir's depth (.npy, disparity = 80 / depth), and
Middlebury's PFM with its non-occluded mask.

Images are decoded by the port itself, with no OpenCV or PIL, into the
arrays the JAX package's PIL and OpenCV calls give, the format picked by
the file's content as `PIL.Image.open` picks it: PNG by `data/png.py` (its
unfilter in the port's own C, `csrc/png_unfilter.c`; the numpy walk there
is the plain version), JPEG (FallingThings) by `data/jpeg.py` (the port's
own decoder in C, `csrc/jpeg_decode.c`), both built at first use by the
host C compiler into `build/kernels/`, and the Netpbm formats by
`read_ppm`.  PFM is read by the port's C
(`data/native_io.read_pfm`, `csrc/native_io.c`, as the JAX package reads it
with its native module); `read_pfm(path, impl="numpy")` is the plain
version.
"""

from __future__ import annotations

import json
import os
import re
from os.path import basename, splitext
from typing import Optional, Tuple, Union

import numpy as np

from anystereo_tpu_torch.data import native_io
from anystereo_tpu_torch.data.jpeg import read_jpeg
from anystereo_tpu_torch.data.png import pil_bool, pil_luminance, read_png
from anystereo_tpu_torch.utils import host_c


def read_pfm(path: str, impl: Optional[str] = None) -> np.ndarray:
    """Portable float map; returns [H, W] or [H, W, 3] float32 (row order
    flipped to top-down).  impl: "c" (the default, `native_io.read_pfm`) or
    "numpy", the plain version."""
    if host_c.resolve(impl, "read_pfm") == "c":
        return native_io.read_pfm(os.fspath(path))
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = f.readline()
        m = re.match(rb"^(\d+)\s(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = map(int, m.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).astype(np.float32)


def write_pfm(path: str, array: np.ndarray) -> None:
    if array.ndim != 2 or splitext(path)[1] != ".pfm":
        raise ValueError(f"write_pfm wants an [H, W] array and a .pfm path, got {array.shape}, {path}")
    h, w = array.shape
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1\n")  # little-endian
        np.flipud(array).astype("<f4").tofile(f)


_FLO_MAGIC = 202021.25


def read_flo(path: str) -> Optional[np.ndarray]:
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != _FLO_MAGIC:
            return None
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, uv: np.ndarray) -> None:
    if uv.ndim != 3 or uv.shape[2] != 2:
        raise ValueError(f"write_flo wants [H, W, 2], got {uv.shape}")
    h, w = uv.shape[:2]
    with open(path, "wb") as f:
        np.array([_FLO_MAGIC], np.float32).tofile(f)
        np.array([w], np.int32).tofile(f)
        np.array([h], np.int32).tofile(f)
        uv.astype(np.float32).tofile(f)


_WHITESPACE = b" \t\n\x0b\x0c\r"
_PPM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB"}


def _ppm_header(data: bytes, path: str):
    """PIL's header parse: the magic (up to 6 bytes, to the first
    whitespace), then tokens of at most 10 bytes, each ended by one
    whitespace byte; a '#' anywhere in a token's run skips to the end of
    its line.  Returns (magic, width, height, maxval or None, data offset)."""
    pos, magic = 0, b""
    while pos < len(data) and len(magic) < 6:
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            break
        magic += c
    if magic not in _PPM_MODES:
        raise ValueError(f"{path}: not a PPM file (magic {magic!r})")

    def token():
        nonlocal pos
        tok = b""
        while len(tok) <= 10:
            c = data[pos:pos + 1]
            pos += 1 if c else 0
            if not c:
                break
            if c in _WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":
                while data[pos:pos + 1] not in (b"\r", b"\n", b""):
                    pos += 1
                pos += 1 if data[pos:pos + 1] else 0
                continue
            tok += c
        if not tok:
            raise ValueError(f"{path}: PPM header ends early")
        if len(tok) > 10:
            raise ValueError(f"{path}: PPM header token {tok[:11]!r} too long")
        return int(tok)

    w, h = token(), token()
    maxval = None
    if _PPM_MODES[magic] != "1":
        maxval = token()
        if not 0 < maxval < 65536:
            raise ValueError(f"{path}: PPM maxval {maxval} is not in 1-65535")
    return magic, w, h, maxval, pos


def _plain_tokens(body: bytes) -> list:
    """The whitespace-separated tokens of a plain PNM body, comments ('#'
    to the end of its line) taken out."""
    parts, pos = [], 0
    while True:
        i = body.find(b"#", pos)
        if i < 0:
            parts.append(body[pos:])
            break
        parts.append(body[pos:i])
        ends = [e for e in (body.find(b"\n", i), body.find(b"\r", i)) if e >= 0]
        if not ends:
            break
        pos = min(ends) + 1
    return b"".join(parts).split()


def read_ppm(path: str) -> np.ndarray:
    """Netpbm images as PIL reads them (`np.array(Image.open(path))`):
    bitmaps (P1 plain, P4 raw) as [H, W] bool, True where the file says 0
    (white), its bytes 0 and 255 as PIL's are; graymaps (P2, P5) as
    [H, W] and pixmaps (P3, P6) as [H, W, 3], at any maxval from 1 to 65535
    and with '#' comments.  PIL's modes:
    uint8 ("L", "RGB"), except a graymap with maxval above 255, which is
    int32 (mode "I"): a raw one at maxval 65535 keeps its values, any other
    is scaled to 0-65535.  Every other maxval scales to 0-255 as
    round(value / maxval * 255) in double, half to even, values above
    maxval clipped (raw) or refused (plain)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, w, h, maxval, pos = _ppm_header(data, path)
    mode = _PPM_MODES[magic]
    bands = 3 if mode == "RGB" else 1
    n = w * h * bands
    if magic == b"P4":
        row = (w + 7) // 8
        body = np.frombuffer(data, np.uint8, offset=pos, count=min(h * row, len(data) - pos))
        if body.size < h * row:
            raise ValueError(f"{path}: PBM data of {body.size} bytes, expected {h * row}")
        return pil_bool(np.unpackbits(body.reshape(h, row), axis=1)[:, :w] == 0)
    if magic == b"P1":
        digits = b"".join(_plain_tokens(data[pos:]))  # plain bitmaps need no space between pixels
        if digits.translate(None, b"01"):
            raise ValueError(f"{path}: PBM data holds bytes other than 0 and 1")
        if len(digits) < n:
            raise ValueError(f"{path}: PBM data of {len(digits)} pixels, expected {n}")
        return pil_bool(np.frombuffer(digits, np.uint8, count=n) == ord("0")).reshape(h, w)
    wide = mode == "L" and maxval > 255  # PIL's mode "I"
    out_max = 65535 if wide else 255
    if magic in (b"P2", b"P3"):
        tokens = _plain_tokens(data[pos:])
        if len(tokens) < n:
            raise ValueError(f"{path}: PNM data of {len(tokens)} values, expected {n}")
        if any(len(t) > 10 for t in tokens[:n]):
            raise ValueError(f"{path}: PNM value longer than 10 bytes")
        values = np.array([int(t) for t in tokens[:n]], np.int64)
        if values.min(initial=0) < 0 or values.max(initial=0) > maxval:
            raise ValueError(f"{path}: PNM value outside 0-{maxval}")
    else:
        dtype = np.dtype(">u2" if maxval > 255 else np.uint8)
        count = min(n, (len(data) - pos) // dtype.itemsize)
        if count < n:
            raise ValueError(f"{path}: PNM data of {count} values, expected {n}")
        values = np.frombuffer(data, dtype, count=n, offset=pos)
        if maxval == 255 or (wide and maxval == 65535):
            return values.astype(np.int32 if wide else np.uint8).reshape((h, w, 3) if bands == 3 else (h, w))
    scaled = np.minimum(np.round(values / maxval * out_max), out_max)
    img = scaled.astype(np.int32 if wide else np.uint8)
    return img.reshape((h, w, 3) if bands == 3 else (h, w))


# leading bytes of other formats PIL opens, to name them in the error
_OTHER_FORMATS = ((b"GIF8", "GIF"), (b"BM", "BMP"), (b"II*\0", "TIFF"), (b"MM\0*", "TIFF"),
                  (b"RIFF", "RIFF (WebP)"), (b"Pf", "PFM"))


def _format(path: str) -> str:
    """The image format of the file at `path` from its leading bytes, as
    PIL's `Image.open` picks its plugin: "png", "jpeg" or "ppm"; anything
    else raises `ValueError` naming what it found."""
    with open(path, "rb") as f:
        head = f.read(16)
    if head.startswith(b"\x89PNG\r\n\x1a\n"):
        return "png"
    if head.startswith(b"\xff\xd8\xff"):
        return "jpeg"
    if head[:2] in _PPM_MODES:
        return "ppm"
    found = next((name for sig, name in _OTHER_FORMATS if head.startswith(sig)), None)
    found = f"a {found} file" if found else f"unknown data starting {head[:8]!r}"
    raise ValueError(f"{path}: not a PNG, JPEG or PPM file (found {found})")


def read_image(path: str) -> np.ndarray:
    """`np.array(PIL.Image.open(path))` for a PNG, JPEG or PPM file, the
    format picked by the file's content, not its name."""
    kind = _format(path)
    if kind == "png":
        return read_png(path, mode="pil")
    if kind == "jpeg":
        return read_jpeg(path)
    return read_ppm(path)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def read_luminance(path: str) -> np.ndarray:
    """`np.asarray(PIL.Image.open(path).convert("L"))` for a PNG, JPEG or PPM
    file: a palette through its `PLTE`, bitmaps 0/255, 16-bit and 32-bit
    gray clipped to 0-255, colour by PIL's (19595 R + 38470 G + 7471 B +
    2^15) >> 16, CMYK through PIL's CMYK to RGB."""
    if _format(path) == "png":
        return read_png(path, mode="L")
    img = read_image(path)
    if img.dtype == bool:
        return np.where(img, 255, 0).astype(np.uint8)
    if img.ndim == 2:
        return np.clip(img, 0, 255).astype(np.uint8)
    x = img.astype(np.int64)
    if img.shape[-1] == 4:  # CMYK: r = k' - k' c / 255 with k' = 255 - k, clipped
        nk = 255 - x[..., 3:]
        x = np.clip(nk - _muldiv255(x[..., :3], nk), 0, 255)
    return pil_luminance(x)


def read_disp_kitti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI's disparity PNG / 256 as float32 (zero = invalid), from the
    array `cv2.imread(path, cv2.IMREAD_ANYDEPTH)` gives: a gray file's
    samples at its depth (16-bit whole), a colour file turned gray at its
    depth (`read_png(..., mode="opencv")`)."""
    if _format(path) != "png":
        raise NotImplementedError(f"{path}: OpenCV's gray decode of a JPEG or PPM disparity map is "
                                  f"not supported (a PNG is)")
    disp = read_png(path, mode="opencv").astype(np.float32) / 256.0
    return disp, disp > 0.0


def read_disp_sintel(path: str) -> Tuple[np.ndarray, np.ndarray]:
    a = read_image(path).astype(np.float32)
    disp = a[..., 0] * 4 + a[..., 1] / 2**6 + a[..., 2] / 2**14
    mask = read_image(path.replace("disparities", "occlusions"))
    return disp, (mask == 0) & (disp > 0)


def read_disp_falling_things(path: str) -> Tuple[np.ndarray, np.ndarray]:
    a = read_image(path).astype(np.float32)
    with open(os.path.join(os.path.dirname(path), "_camera_settings.json")) as f:
        intr = json.load(f)
    fx = intr["camera_settings"][0]["intrinsic_settings"]["fx"]
    disp = (fx * 6.0 * 100) / a
    return disp, disp > 0


def read_disp_tartanair(path: str) -> Tuple[np.ndarray, np.ndarray]:
    depth = np.load(path)
    disp = 80.0 / depth
    return disp, disp > 0


def read_disp_middlebury(path: str):
    if basename(path) == "disp0GT.pfm":
        disp = read_pfm(path)
        nocc = read_image(path.replace("disp0GT.pfm", "mask0nocc.png")) == 255
        return disp, nocc
    if basename(path) == "disp0.pfm":
        disp = read_pfm(path)
        return disp, disp < 1e3
    raise ValueError(path)


def read_gen(path: str) -> Union[np.ndarray, list]:
    """Generic reader: images as uint8 arrays, .pfm disparities as [H, W]
    float32, .flo as [H, W, 2], .bin/.raw with `np.load`; [] for any other
    extension."""
    ext = splitext(path)[-1]
    if ext in (".png", ".jpeg", ".ppm", ".jpg"):
        return read_image(path)
    if ext in (".bin", ".raw"):
        return np.load(path)
    if ext == ".flo":
        return read_flo(path).astype(np.float32)
    if ext == ".pfm":
        flow = read_pfm(path)
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    return []
