"""PNG decode and encode on `zlib` and numpy.

The JAX package reads images with PIL (`np.array(Image.open(path))`) and
KITTI's 16-bit disparities with `cv2.imread(path, cv2.IMREAD_ANYDEPTH)`; the
port depends on neither, and this module stands in for their PNG decode.
`read_png` gives the array PIL gives: [H, W] for gray, [H, W, 2] gray+alpha,
[H, W, 3] RGB, [H, W, 4] RGBA, uint8 at bit depth 8 and native-endian uint16
at 16 (the value `cv2.IMREAD_UNCHANGED` gives; PIL keeps only the high byte
of 16-bit colour), and for a palette image the [H, W] indices, as PIL's
mode "P" does.  Bit depths 1, 2 and 4 and interlaced files raise
`NotImplementedError`.

Unfiltering: a byte's predictor reads the byte one pixel to its left, the
byte above and the byte above-left, so a row cannot be unfiltered along its
length in one vector step, but every pixel on one anti-diagonal (row r,
pixel t - r) depends only on the two anti-diagonals before it.  The image is
laid out skewed, [t, r, byte], and walked one anti-diagonal at a time, all
five filter types at once: H + W numpy steps over at most H pixels each.
Files whose rows use only None, Sub and Up (as `write_png`'s do) are
unfiltered a row at a time.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _unfilter_rows(kind: np.ndarray, filt: np.ndarray, bpp: int) -> np.ndarray:
    """Rows filtered by None, Sub or Up only: each row in one vector step
    (Sub is a running sum mod 256 over each byte of the pixel)."""
    out = np.empty_like(filt)
    prev = np.zeros(filt.shape[1], np.uint8)
    for r, k in enumerate(kind):
        row = filt[r]
        if k == 1:
            row = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif k == 2:
            row = row + prev
        out[r] = prev = row
    return out


def _unfilter_diagonals(kind: np.ndarray, filt: np.ndarray, bpp: int) -> np.ndarray:
    """Any filter types, one anti-diagonal at a time (module docstring)."""
    h, w = filt.shape[0], filt.shape[1] // bpp
    # skewed[t + 2, r + 1] holds pixel (r, t - r); rows 0-1 and column 0 stay
    # 0 as the neighbours outside the image
    skewed = np.zeros((w + h + 2, h + 1, bpp), np.int16)
    r_idx, p_idx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    fs = np.zeros_like(skewed)
    fs[r_idx + p_idx + 2, r_idx + 1] = filt.reshape(h, w, bpp)
    k = kind[:, None]
    sub, up, avg, paeth = (k == 1), (k == 2), (k == 3), (k == 4)
    for t in range(w + h - 1):
        r0, r1 = max(0, t - w + 1), min(h - 1, t)
        rows, above = slice(r0 + 1, r1 + 2), slice(r0, r1 + 1)
        a, b, c = skewed[t + 1, rows], skewed[t + 1, above], skewed[t, above]  # left, up, up-left
        ac, bc = a - c, b - c
        pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(ac + bc)
        pred = np.where(paeth[above], np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)),
                        np.where(avg[above], (a + b) >> 1,
                                 np.where(up[above], b, np.where(sub[above], a, 0))))
        cur = skewed[t + 2, rows]
        np.add(fs[t + 2, rows], pred, out=cur)
        cur &= 0xFF
    return skewed[r_idx + p_idx + 2, r_idx + 1].astype(np.uint8).reshape(filt.shape)


def _unfilter(raw: np.ndarray, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """raw: the decompressed stream, h rows of (filter byte, row_bytes
    bytes).  Returns the unfiltered [h, row_bytes] uint8."""
    rows = raw.reshape(h, row_bytes + 1)
    kind, filt = rows[:, 0], rows[:, 1:]
    if kind.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {int(kind.max())} is not one of 0-4")
    if kind.max(initial=0) <= 2:
        return _unfilter_rows(kind, filt, bpp)
    return _unfilter_diagonals(kind, filt, bpp)


def read_png(path: str) -> np.ndarray:
    """Decode the PNG at `path` (see the module docstring for the array)."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat, palette = None, [], None
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = body
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if interlace:
        raise NotImplementedError(f"{path}: interlaced PNG files are not supported")
    if colour not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {colour} is not defined")
    if depth not in (8, 16):
        raise NotImplementedError(f"{path}: PNG bit depth {depth} is not supported (8 and 16 are)")
    if colour == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[colour]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: PNG image data of {raw.size} bytes, expected {h * (w * bpp + 1)}")
    img = _unfilter(raw, h, w * bpp, bpp)
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def _filter(rows: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    """PNG filter `kind` (0-4) of every row of [H, row_bytes] uint8."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:] = a[:-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = [0, a, b, (a + b) >> 1,
            np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))][kind]
    return ((x - pred) & 0xFF).astype(np.uint8)


def write_png(path: str, arr: np.ndarray, filter_type: int = 0) -> None:
    """Encode `arr` as a PNG: [H, W] gray or [H, W, 3] RGB, uint8 (bit
    depth 8) or uint16 (16), every row with PNG filter `filter_type` (0 None,
    1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.uint16) or not (
            arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"write_png wants uint8 or uint16 [H, W] or [H, W, 3], got "
                         f"{arr.dtype} {arr.shape}")
    if filter_type not in range(5):
        raise ValueError(f"PNG filter type {filter_type} is not one of 0-4")
    h, w = arr.shape[:2]
    depth = 8 if arr.dtype == np.uint8 else 16
    colour = 0 if arr.ndim == 2 else 2
    rows = np.ascontiguousarray(arr.astype(">u2") if depth == 16 else arr).view(np.uint8)
    rows = _filter(rows.reshape(h, -1), _CHANNELS[colour] * depth // 8, filter_type)
    rows = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(chunk(b"IEND", b""))
