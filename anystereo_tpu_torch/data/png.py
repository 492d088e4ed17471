"""PNG decode and encode on `zlib` and numpy.

The JAX package reads images with PIL (`np.array(Image.open(path))`),
Middlebury's masks with PIL's `convert("L")` and KITTI's disparities with
`cv2.imread(path, cv2.IMREAD_ANYDEPTH)`; the port depends on neither, and
this module stands in for their PNG decode.  `decode_png` reads every file
the PNG specification allows: gray at bit depth 1, 2, 4, 8 and 16, palette
at 1, 2, 4 and 8, RGB, gray+alpha and RGBA at 8 and 16, interlaced (Adam7)
or not, into its samples (`Png`: 16-bit values whole, as
`cv2.IMREAD_UNCHANGED` gives them).  `read_png(path, mode=...)` turns the
samples into one of three arrays:

- "pil" (the default): PIL's array.  1-bit gray is bool (its bytes 0 and
  255, as PIL's are), 2- and 4-bit gray uint8 scaled to 0-255 (x 85, x 17),
  8-bit uint8, 16-bit gray uint16; a palette image gives its indices (mode
  "P"); 16-bit RGB and RGBA keep the high byte of each sample, and 16-bit
  gray+alpha becomes RGBA (gray, gray, gray, alpha; high bytes).  A `tRNS`
  chunk changes none of these.
- "opencv": `cv2.imread(path, cv2.IMREAD_ANYDEPTH)`, libpng's transforms
  as OpenCV asks for them: sub-byte gray scaled to 8 bits, alpha dropped,
  a palette expanded through its `PLTE` (entries it lacks are black), and
  colour turned gray at the file's depth by libpng's `rgb_to_gray` (red
  0.299, green 0.587; 15-bit fixed point, truncated at 8 bits, rounded at
  16, and a pixel with R = G = B kept at 8).  A colour file with an `sRGB`
  chunk or a `gAMA` other than 1.0 would have libpng convert through its
  gamma tables: `NotImplementedError`.
- "L": PIL's `convert("L")` of its image: (19595 R + 38470 G + 7471 B +
  2^15) >> 16 of RGB, RGBA and palette entries, 0/255 for 1-bit, 16-bit
  gray clipped at 255, 16-bit colour from its high bytes.

Unfiltering runs in the port's own C, `csrc/png_unfilter.c`, built at
first use by the host C compiler into `build/kernels/`
(`ops/kernels/build.py`; no fallback: a missing compiler raises).  An
interlaced file is seven sub-images, each with its own filter bytes: each
pass is unfiltered by the same C function and then placed on its grid.
Sub-byte samples are unfiltered a byte at a time (the filter's step is
one byte below 8 bits a pixel) and unpacked afterwards, the padding bits
at the end of each row dropped.  The inflate is the standard library's
`zlib`.

The plain version, `read_png(path, impl="numpy")`, unfilters in numpy: a
byte's predictor reads the byte one pixel to its left, the byte above and
the byte above-left, so a row cannot be unfiltered along its length in one
vector step, but every pixel on one anti-diagonal (row r, pixel t - r)
depends only on the two anti-diagonals before it.  The image is laid out
skewed, [t, r, byte], and walked one anti-diagonal at a time, all five
filter types at once: H + W numpy steps over at most H pixels each.  Files
whose rows use only None, Sub and Up are unfiltered a row at a time.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

from anystereo_tpu_torch.utils import host_c

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
MODES = ("pil", "opencv", "L")


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


def _unfilter_numpy(raw: np.ndarray, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """raw: the decompressed stream, h rows of (filter byte, row_bytes
    bytes).  Returns the unfiltered [h, row_bytes] uint8 (the plain version
    of `_unfilter_c`)."""
    rows = raw.reshape(h, row_bytes + 1)
    kind, filt = rows[:, 0], rows[:, 1:]
    if kind.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {int(kind.max())} is not one of 0-4")
    if kind.max(initial=0) <= 2:
        return _unfilter_rows(kind, filt, bpp)
    return _unfilter_diagonals(kind, filt, bpp)


def _unfilter_c(raw: np.ndarray, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    if raw.dtype != np.uint8 or raw.size != h * (row_bytes + 1) or not raw.flags.c_contiguous or bpp < 1:
        raise ValueError(f"PNG unfilter: {raw.dtype} stream of {raw.size} bytes for {h} rows of "
                         f"{row_bytes} bytes, {bpp} a pixel")
    out = np.empty((h, row_bytes), np.uint8)
    unfilter = host_c.function("png_unfilter", "png_unfilter", [host_c.P, host_c.P] + [host_c.I64] * 3,
                               host_c.I64)
    bad = unfilter(raw.ctypes.data, out.ctypes.data, h, row_bytes, bpp)
    if bad >= 0:
        raise ValueError(f"PNG filter type {int(raw[bad * (row_bytes + 1)])} is not one of 0-4")
    return out


_UNFILTER = {"c": _unfilter_c, "numpy": _unfilter_numpy}


class Png(NamedTuple):
    """A decoded PNG: `samples` [H, W, samples a pixel] at the file's depth
    (uint8 up to 8 bits, the sub-byte values unscaled; uint16 at 16), its
    colour type and bit depth, its `PLTE` as [entries, 3] uint8 (or None),
    and whether it carries an `sRGB` chunk or a `gAMA` other than 1.0 (as
    libpng rounds it)."""
    samples: np.ndarray
    colour: int
    depth: int
    palette: Optional[np.ndarray]
    gamma: bool


def _unpack(rows: np.ndarray, depth: int, width: int) -> np.ndarray:
    """[h, row_bytes] of packed `depth`-bit samples (MSB first) -> [h, width]
    uint8; the padding bits at the end of a row are dropped."""
    if depth == 8:
        return rows[:, :width]
    bits = np.unpackbits(rows, axis=1)[:, :width * depth].reshape(rows.shape[0], width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)


def _samples(img: np.ndarray, h: int, w: int, depth: int, ch: int) -> np.ndarray:
    """Unfiltered [h, row_bytes] uint8 -> [h, w, ch] samples."""
    if depth == 16:
        return img.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth < 8:
        return _unpack(img, depth, w)[..., None]
    return img.reshape(h, w, ch)


def _significant(gamma: int) -> bool:
    """libpng's png_gamma_significant of a `gAMA` (x 100000) or of its
    reciprocal, which libpng takes as the screen's: 1.0 +- 0.05 is none."""
    return gamma != 0 and any(not 95_000 <= g <= 105_000 for g in (gamma, int(1e10 / gamma + 0.5)))


def decode_png(path: str, impl: str = "c") -> Png:
    """Decode the PNG at `path` into its samples (see `Png`).  `impl="numpy"`
    unfilters with the plain version instead of the C one."""
    if impl not in _UNFILTER:
        raise ValueError(f"read_png: impl {impl!r} is not one of {sorted(_UNFILTER)}")
    with open(path, "rb") as f:
        data = f.read()
    header, idat, palette, gamma = None, [], None, False
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{path}: IHDR chunk of {len(body)} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            if len(body) % 3 or not body:
                raise ValueError(f"{path}: PLTE chunk of {len(body)} bytes")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"sRGB" or (kind == b"gAMA" and len(body) == 4):
            gamma = gamma or kind == b"sRGB" or _significant(struct.unpack(">I", body)[0])
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if not (w and h):
        raise ValueError(f"{path}: PNG of {w}x{h} pixels")
    if colour not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {colour} is not defined")
    if depth not in _DEPTHS[colour]:
        raise ValueError(f"{path}: PNG bit depth {depth} is not defined for colour type {colour} "
                         f"(it allows {_DEPTHS[colour]})")
    if interlace > 1:
        raise ValueError(f"{path}: PNG interlace method {interlace} is not defined (0 and 1 are)")
    if colour == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[colour]
    bits = ch * depth
    bpp = max(1, bits // 8)  # the filters' byte step
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = [(0, 0, 1, 1)] if not interlace else _ADAM7
    sizes = []
    for x0, y0, dx, dy in passes:
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        sizes.append((pw, ph, (pw * bits + 7) // 8 if pw and ph else 0))
    need = sum(ph * (rb + 1) for pw, ph, rb in sizes if rb)
    if raw.size != need:
        raise ValueError(f"{path}: PNG image data of {raw.size} bytes, expected {need}")
    out = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8) if interlace else None
    pos = 0
    for (x0, y0, dx, dy), (pw, ph, rb) in zip(passes, sizes):
        if not rb:
            continue  # an empty pass carries no bytes, not even filter types
        img = _samples(_UNFILTER[impl](raw[pos:pos + ph * (rb + 1)], ph, rb, bpp), ph, pw, depth, ch)
        pos += ph * (rb + 1)
        if out is None:  # not interlaced: the one pass is the image
            out = img
        else:
            out[y0::dy, x0::dx] = img
    return Png(out, colour, depth, palette, gamma)


def pil_luminance(rgb: np.ndarray) -> np.ndarray:
    """PIL's luminance of [..., 3] samples 0-255: (19595 R + 38470 G + 7471 B
    + 2^15) >> 16, as uint8."""
    x = rgb.astype(np.int64)
    return ((19595 * x[..., 0] + 38470 * x[..., 1] + 7471 * x[..., 2] + 0x8000) >> 16).astype(np.uint8)


def _palette_rgb(p: Png) -> np.ndarray:
    """The palette's colour of each pixel; indices past the `PLTE` are black."""
    table = np.zeros((256, 3), np.uint8)
    table[:len(p.palette)] = p.palette[:256]
    return table[p.samples[..., 0]]


def pil_bool(bits: np.ndarray) -> np.ndarray:
    """A bitmap as PIL's mode "1" gives it to numpy: bool whose bytes are 0
    and 255 (not numpy's 0 and 1; the values compare the same, the bytes
    differ)."""
    return np.where(bits, 255, 0).astype(np.uint8).view(bool)


def _expand_gray(g: np.ndarray, depth: int) -> np.ndarray:
    """Sub-byte gray scaled to 0-255, as PIL's "1"->"L" and libpng's expand do."""
    return (g * (255 // ((1 << depth) - 1))).astype(np.uint8) if depth < 8 else g


def _as_pil(p: Png) -> np.ndarray:
    x, colour, depth = p.samples, p.colour, p.depth
    if colour == 0:
        g = x[..., 0]
        return pil_bool(g) if depth == 1 else _expand_gray(g, depth)
    if colour == 3:
        return x[..., 0]
    if depth == 16:
        x = (x >> 8).astype(np.uint8)
        if colour == 4:  # PIL reads 16-bit gray+alpha as RGBA
            x = x[..., [0, 0, 0, 1]]
    return x


def _as_opencv(p: Png, path: str) -> np.ndarray:
    x, colour, depth = p.samples, p.colour, p.depth
    if colour in (0, 4):
        return _expand_gray(x[..., 0], depth)
    if p.gamma:
        raise NotImplementedError(f"{path}: a colour PNG with a gAMA or sRGB chunk, which libpng turns "
                                  f"gray through its gamma tables for OpenCV, is not supported as a "
                                  f"disparity map")
    rgb = _palette_rgb(p) if colour == 3 else x[..., :3]
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    # png_set_rgb_to_gray(0.299, 0.587): coefficients 29900 and 58700 of
    # 100000 scaled to 2^15 and truncated, blue the rest
    gray = 9797 * r + 19234 * g + 3737 * b
    if rgb.dtype == np.uint16:
        return ((gray + 16384) >> 15).astype(np.uint16)
    return np.where((r == g) & (r == b), r, gray >> 15).astype(np.uint8)


def _as_l(p: Png) -> np.ndarray:
    x, colour, depth = p.samples, p.colour, p.depth
    if colour == 0:
        g = x[..., 0]
        return np.minimum(g, 255).astype(np.uint8) if depth == 16 else _expand_gray(g, depth)
    if colour == 3:
        return pil_luminance(_palette_rgb(p))
    if depth == 16:
        x = (x >> 8).astype(np.uint8)
    return x[..., 0] if colour == 4 else pil_luminance(x[..., :3])


def read_png(path: str, impl: str = "c", mode: str = "pil") -> np.ndarray:
    """Decode the PNG at `path` into the array of `mode` (the module
    docstring: "pil", "opencv" or "L").  `impl="numpy"` unfilters
    with the plain version instead of the C one."""
    if mode not in MODES:
        raise ValueError(f"read_png: mode {mode!r} is not one of {MODES}")
    p = decode_png(path, impl)
    if mode == "opencv":
        return _as_opencv(p, path)
    if mode == "L":
        return _as_l(p)
    return _as_pil(p)


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
