"""The port's native readers against their plain version and the JAX
package's readers: the C PNG unfilter (`csrc/png_unfilter.c`) against the
numpy walk (`read_png(path, impl="numpy")`) and PIL or OpenCV, and the C
baseline JPEG decoder (`csrc/jpeg_decode.c`) against the JAX package's
`read_gen`, which is `np.array(PIL.Image.open(path))` on libjpeg-turbo.
Both C sources are built here by the host C compiler, as on the card's
host.

Tolerances: none.  Every decoded array equals its reference exactly.

The JPEG fixtures under `tests/data/jpeg/` (read on the card's host, which
has no PIL) are written by `write_jpeg_fixtures()`:

    JAX_PLATFORMS=cpu PYTHONPATH=. python -c "import tests.conftest, \
        tests.test_torch_readers as t; t.write_jpeg_fixtures()"

and `test_jpeg_fixture_digests_are_pils` holds their recorded digests to
PIL's decode of the committed files.
"""

import hashlib
import json
import os
import struct
import subprocess
import sys
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
from PIL import Image  # noqa: E402

from anystereo_tpu.data import frame_utils as jfu  # noqa: E402
from anystereo_tpu_torch.data import frame_utils as tfu  # noqa: E402
from anystereo_tpu_torch.data import png as tpng  # noqa: E402
from anystereo_tpu_torch.data.jpeg import read_jpeg  # noqa: E402
from anystereo_tpu_torch.data.png import read_png, write_png  # noqa: E402
from anystereo_tpu_torch.ops.kernels import build  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "jpeg"
STEREO_SEED = 15  # `chip_smoke._stereo_pair` seed of the 540x960 pair


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module, restored afterwards: a parallel
    test run puts several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _texture(rng, shape, dtype=np.uint8, sigma=1.0):
    from scipy.ndimage import gaussian_filter

    x = gaussian_filter(rng.rand(*shape), sigma)
    x = (x - x.min()) / max(float(x.max() - x.min()), 1e-9)
    return (x * np.iinfo(dtype).max).astype(dtype)


# ------------------------------------------------------------------- PNG

_SAMPLES = tpng._CHANNELS  # colour type -> samples a pixel


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def _png_bytes(arr, depth, colour, kinds, stream=None):
    """A PNG file of `arr` ([H, W, samples]) at `depth` and `colour`, row r
    filtered by PNG filter kinds[r]; `stream` replaces the filtered data."""
    h, w = arr.shape[:2]
    rows = np.ascontiguousarray(arr.astype(">u2") if depth == 16 else arr.astype(np.uint8))
    rows = rows.view(np.uint8).reshape(h, -1)
    bpp = _SAMPLES[colour] * depth // 8
    by_kind = [tpng._filter(rows, bpp, k) for k in range(5)]
    filt = np.stack([by_kind[k][r] for r, k in enumerate(kinds)])
    if stream is None:
        stream = np.concatenate([np.asarray(kinds, np.uint8)[:, None], filt], axis=1).tobytes()
    body = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
    if colour == 3:
        body += _chunk(b"PLTE", bytes(range(256)) * 3)
    return body + _chunk(b"IDAT", zlib.compress(stream)) + _chunk(b"IEND", b"")


def _image(rng, h, w, depth, colour):
    arr = _texture(rng, (h, w, _SAMPLES[colour]), np.uint16 if depth == 16 else np.uint8)
    if colour == 3:
        arr = arr.astype(np.uint8)
    return arr


def _unchanged(path, depth, colour):
    """The samples OpenCV's IMREAD_UNCHANGED gives, as [H, W, samples] in the
    file's order: PIL gives no whole 16-bit colour to compare with."""
    x = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return {2: lambda: x[..., ::-1], 4: lambda: x[..., [0, 3]], 6: lambda: x[..., [2, 1, 0, 3]]}[colour]()


def _check_png(path, arr, depth, colour):
    """The samples (`decode_png`, C and numpy) equal the image written, and
    OpenCV's whole 16-bit colour; `read_png` gives PIL's array."""
    got = tpng.decode_png(path).samples
    plain = tpng.decode_png(path, impl="numpy").samples
    assert got.dtype == arr.dtype and got.shape == arr.shape
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(got, plain)
    if depth == 16 and colour != 0:
        np.testing.assert_array_equal(got, _unchanged(path, depth, colour))
    pil = read_png(path)
    want = np.array(Image.open(path))
    assert pil.dtype == want.dtype and pil.shape == want.shape
    np.testing.assert_array_equal(pil, want)


FORMATS = [(8, 0), (16, 0), (8, 2), (16, 2), (8, 3), (8, 4), (16, 4), (8, 6), (16, 6)]


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("depth,colour", FORMATS)
def test_unfilter_each_filter_type(tmp_path, depth, colour, filter_type):
    """Every row of one filter type: the C unfilter equals the image, the
    numpy plain version and PIL / OpenCV, byte for byte."""
    rng = np.random.RandomState(100 * depth + 10 * colour + filter_type)
    arr = _image(rng, 9, 13, depth, colour)
    p = str(tmp_path / "f.png")
    with open(p, "wb") as f:
        f.write(_png_bytes(arr, depth, colour, [filter_type] * 9))
    _check_png(p, arr, depth, colour)


@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("w", [1, 2, 3, 33])
@pytest.mark.parametrize("depth,colour", [(8, 2), (16, 0), (8, 4), (16, 6)])
def test_unfilter_mixed_rows_small(tmp_path, depth, colour, w, h):
    """Rows of mixed filter types (a stream `write_png` does not write) at
    the narrowest widths and heights."""
    rng = np.random.RandomState(w * 7 + h)
    arr = _image(rng, h, w, depth, colour)
    p = str(tmp_path / "m.png")
    with open(p, "wb") as f:
        f.write(_png_bytes(arr, depth, colour, list(rng.permutation(5)[:h])))
    _check_png(p, arr, depth, colour)


@pytest.mark.parametrize("depth,colour", [(8, 2), (16, 0)])
def test_unfilter_mixed_rows_full_frame(tmp_path, depth, colour):
    """A 540x960 frame whose rows cycle through all five filter types in a
    seeded order, as libpng's adaptive filtering mixes them."""
    rng = np.random.RandomState(depth)
    arr = _image(rng, 540, 960, depth, colour)
    p = str(tmp_path / "frame.png")
    with open(p, "wb") as f:
        f.write(_png_bytes(arr, depth, colour, list(rng.randint(0, 5, 540))))
    _check_png(p, arr, depth, colour)


def test_unfilter_refuses_filter_type_above_4(tmp_path):
    arr = _image(np.random.RandomState(0), 4, 5, 8, 2)
    kinds = [0, 1, 2, 3]
    good = _png_bytes(arr, 8, 2, kinds)
    raw = bytearray(zlib.decompress(good[good.index(b"IDAT") + 4:good.index(b"IEND") - 8]))
    raw[2 * (5 * 3 + 1)] = 7  # row 2
    p = str(tmp_path / "bad.png")
    with open(p, "wb") as f:
        f.write(_png_bytes(arr, 8, 2, kinds, stream=bytes(raw)))
    for impl in ("c", "numpy"):
        with pytest.raises(ValueError, match="filter type 7"):
            read_png(p, impl=impl)


# ------------------------------------------------------------------ JPEG

SIZES = [(1, 1), (7, 9), (17, 33), (21, 33)]
SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


def _jpeg_pil(path, arr, **kw):
    Image.fromarray(arr).save(path, "JPEG", **kw)
    return path


def _jpeg_cv2(path, arr, *params):
    ok, enc = cv2.imencode(".jpg", arr[..., ::-1] if arr.ndim == 3 else arr, list(params))
    assert ok
    with open(path, "wb") as f:
        f.write(enc.tobytes())
    return path


def _check_jpeg(path):
    want = jfu.read_gen(path)
    got = tfu.read_gen(path)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("subsampling", list(SUBSAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_jpeg_pil_files(tmp_path, quality, subsampling, size):
    rng = np.random.RandomState(quality + SUBSAMPLING[subsampling] + size[1])
    arr = _texture(rng, size + (3,))
    _check_jpeg(_jpeg_pil(str(tmp_path / "a.jpg"), arr, quality=quality,
                          subsampling=SUBSAMPLING[subsampling]))


@pytest.mark.parametrize("subsampling", list(SUBSAMPLING))
def test_jpeg_full_frame(tmp_path, subsampling):
    rng = np.random.RandomState(SUBSAMPLING[subsampling])
    arr = _texture(rng, (540, 960, 3), sigma=1.2)
    _check_jpeg(_jpeg_pil(str(tmp_path / "f.jpg"), arr, quality=95, subsampling=SUBSAMPLING[subsampling]))


@pytest.mark.parametrize("size", SIZES + [(540, 960)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_gray(tmp_path, size):
    arr = _texture(np.random.RandomState(size[0]), size)
    _check_jpeg(_jpeg_pil(str(tmp_path / "g.jpg"), arr, quality=90))


@pytest.mark.parametrize("subsampling", list(SUBSAMPLING))
def test_jpeg_optimized_huffman(tmp_path, subsampling):
    arr = _texture(np.random.RandomState(5), (45, 67, 3))
    _check_jpeg(_jpeg_pil(str(tmp_path / "o.jpg"), arr, quality=85, optimize=True,
                          subsampling=SUBSAMPLING[subsampling]))


@pytest.mark.parametrize("size", SIZES + [(540, 960)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_opencv_440(tmp_path, size):
    arr = _texture(np.random.RandomState(size[1]), size + (3,))
    _check_jpeg(_jpeg_cv2(str(tmp_path / "v.jpg"), arr, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440))


@pytest.mark.parametrize("interval", [1, 3, 8])
@pytest.mark.parametrize("size", SIZES[1:] + [(540, 960)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_opencv_restart_intervals(tmp_path, size, interval):
    arr = _texture(np.random.RandomState(interval), size + (3,))
    _check_jpeg(_jpeg_cv2(str(tmp_path / "r.jpg"), arr, cv2.IMWRITE_JPEG_RST_INTERVAL, interval))


def test_jpeg_rgb_by_adobe_marker(tmp_path):
    """An Adobe marker with transform 0 says the components are R, G, B:
    no colour conversion, as libjpeg decides."""
    arr = _texture(np.random.RandomState(8), (17, 33, 3))
    p = _jpeg_pil(str(tmp_path / "y.jpg"), arr, quality=90, subsampling=0)
    data = open(p, "rb").read()
    app0 = data.index(b"\xff\xe0")
    length = struct.unpack(">H", data[app0 + 2:app0 + 4])[0]
    adobe = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0])
    with open(p, "wb") as f:  # the JFIF marker out, an Adobe one in
        f.write(data[:app0] + adobe + data[app0 + 2 + length:])
    assert Image.open(p).info.get("adobe_transform") == 0
    _check_jpeg(p)


def _segments(data):
    """(marker, body) of every marker segment before the first SOS, and the
    SOS segment and entropy-coded data up to the EOI as the last entry."""
    out, pos = [], 2
    while True:
        marker, n = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xDA:
            out.append((marker, data[pos + 4:pos + 2 + n], data[pos + 2 + n:data.rindex(b"\xff\xd9")]))
            return out
        out.append((marker, data[pos + 4:pos + 2 + n]))
        pos += 2 + n


def _segment(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _join(segments, scans):
    return b"\xff\xd8" + b"".join(_segment(m, b) for m, b in segments) + b"".join(
        _segment(0xDA, head) + data for head, data in scans) + b"\xff\xd9"


@pytest.mark.parametrize("form", ["SOF1", "16-bit DQT"])
def test_jpeg_extended_sequential_forms(tmp_path, form):
    """The SOF1 marker (extended sequential Huffman) and 16-bit quantization
    tables, rewritten into a baseline file: the same decode as libjpeg's."""
    p = _jpeg_pil(str(tmp_path / "e.jpg"), _texture(np.random.RandomState(9), (21, 33, 3)), quality=80)
    *segments, (_, head, data) = _segments(open(p, "rb").read())
    out = []
    for m, body in segments:
        if form == "SOF1" and m == 0xC0:
            m = 0xC1
        if form == "16-bit DQT" and m == 0xDB:
            tables, i = b"", 0
            while i < len(body):
                tables += bytes([0x10 | body[i] & 15]) + np.asarray(
                    list(body[i + 1:i + 65]), ">u2").tobytes()
                i += 65
            body = tables
        out.append((m, body))
    with open(p, "wb") as f:
        f.write(_join(out, [(head, data)]))
    _check_jpeg(p)


class _Bits:
    """MSB-first bits of entropy-coded data (stuffed zeros removed), and
    their writer."""

    def __init__(self, data=b""):
        self.bits = "".join(f"{b:08b}" for b in data.replace(b"\xff\x00", b"\xff"))
        self.pos, self.out = 0, []

    def read(self, n):
        v = int(self.bits[self.pos:self.pos + n] or "0", 2)
        self.pos += n
        return v

    def write(self, code, n):
        if n:
            self.out.append(format(code, f"0{n}b"))

    def flush(self):
        bits = "".join(self.out)
        bits += "1" * (-len(bits) % 8)
        data = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
        return data.replace(b"\xff", b"\xff\x00")


def _huffman_tables(body):
    """DHT body -> {(class, id): {(length, code): symbol}}."""
    tables, i = {}, 0
    while i < len(body):
        counts, code, k, table = body[i + 1:i + 17], 0, i + 17, {}
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                table[(length, code)] = body[k]
                code, k = code + 1, k + 1
            code <<= 1
        tables[(body[i] >> 4, body[i] & 15)] = table
        i = k
    return tables


def _decode_symbol(bits, table):
    code = 0
    for length in range(1, 17):
        code = (code << 1) | bits.read(1)
        if (length, code) in table:
            return table[(length, code)]
    raise AssertionError("no Huffman code")


def _extend(v, s):
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _split_scans(data: bytes) -> bytes:
    """A baseline file's one interleaved scan re-coded as three scans of one
    component each (the same coefficients and tables): the other sequential
    form, which no common encoder writes."""
    *segments, (_, head, entropy) = _segments(data)
    tables = {}
    for m, body in segments:
        if m == 0xC4:
            tables.update(_huffman_tables(body))
    sof = next(body for m, body in segments if m == 0xC0)
    h, w = struct.unpack(">HH", sof[1:5])
    comps = [(sof[6 + 3 * i], sof[7 + 3 * i] >> 4, sof[7 + 3 * i] & 15) for i in range(sof[5])]
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    sel = {head[1 + 2 * i]: head[2 + 2 * i] for i in range(head[0])}
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    blocks = {cid: {} for cid, _, _ in comps}
    bits, pred = _Bits(entropy), {cid: 0 for cid, _, _ in comps}
    for my in range(mcuy):
        for mx in range(mcux):
            for cid, ch, cv in comps:
                dc, ac = tables[(0, sel[cid] >> 4)], tables[(1, sel[cid] & 15)]
                for by in range(cv):
                    for bx in range(ch):
                        s = _decode_symbol(bits, dc)
                        pred[cid] += _extend(bits.read(s), s)
                        coef, k = [pred[cid]] + [0] * 63, 1
                        while k < 64:
                            rs = _decode_symbol(bits, ac)
                            if rs == 0:
                                break
                            k += rs >> 4
                            coef[k] = _extend(bits.read(rs & 15), rs & 15)
                            k += 1
                        blocks[cid][(my * cv + by, mx * ch + bx)] = coef
    scans = []
    for cid, ch, cv in comps:
        dc, ac = ({v: k for k, v in tables[(t, sel[cid] >> 4 if t == 0 else sel[cid] & 15)].items()}
                  for t in (0, 1))
        out, last = _Bits(), 0
        rows, cols = -(-(-(-h * cv // vmax)) // 8), -(-(-(-w * ch // hmax)) // 8)
        for r in range(rows):
            for c in range(cols):
                coef = blocks[cid][(r, c)]
                diff, last = coef[0] - last, coef[0]
                s = abs(diff).bit_length()
                out.write(*dc[s][::-1])
                out.write(diff if diff >= 0 else diff + (1 << s) - 1, s)
                run = 0
                for k in range(1, 64):
                    if coef[k] == 0:
                        run += 1
                        continue
                    while run > 15:
                        out.write(*ac[0xF0][::-1])
                        run -= 16
                    s = abs(coef[k]).bit_length()
                    out.write(*ac[(run << 4) | s][::-1])
                    out.write(coef[k] if coef[k] >= 0 else coef[k] + (1 << s) - 1, s)
                    run = 0
                if run:
                    out.write(*ac[0][::-1])
        scans.append((bytes([1, cid, sel[cid], 0, 63, 0]), out.flush()))
    return _join(segments, scans)


@pytest.mark.parametrize("size", [(17, 33), (21, 33)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("subsampling", list(SUBSAMPLING))
def test_jpeg_one_component_a_scan(tmp_path, subsampling, size):
    """Three scans of one component each (non-interleaved: a component's own
    block grid, no dummy blocks) decode as libjpeg decodes them."""
    p = _jpeg_pil(str(tmp_path / "i.jpg"), _texture(np.random.RandomState(4), size + (3,)), quality=85,
                  subsampling=SUBSAMPLING[subsampling])
    data = open(p, "rb").read()
    split = str(tmp_path / "split.jpg")
    with open(split, "wb") as f:
        f.write(_split_scans(data))
    assert open(split, "rb").read().count(b"\xff\xda") == 3
    _check_jpeg(split)
    np.testing.assert_array_equal(tfu.read_gen(split), tfu.read_gen(p))


def test_jpeg_refuses_progressive(tmp_path):
    """Progressive Huffman files decode (`tests/test_torch_formats.py`); what
    is left of progressive JPEG is refused by name: arithmetic coding
    (SOF10), and a file whose scans stop before AC coefficients 1-9 are
    finished, which libjpeg would smooth (here the file cut after its first
    scan)."""
    p = _jpeg_pil(str(tmp_path / "prog.jpg"), _texture(np.random.RandomState(1), (17, 33, 3)),
                  progressive=True)
    data = open(p, "rb").read()
    np.testing.assert_array_equal(tfu.read_gen(p), jfu.read_gen(p))
    with open(p, "wb") as f:
        f.write(data.replace(b"\xff\xc2", b"\xff\xca", 1))
    with pytest.raises(NotImplementedError, match="prog.jpg.*arithmetic-coded JPEG \\(SOF10\\)"):
        tfu.read_gen(p)
    second_scan = data.index(b"\xff\xda", data.index(b"\xff\xda") + 2)
    with open(p, "wb") as f:
        f.write(data[:second_scan] + b"\xff\xd9")
    assert jfu.read_gen(p).shape == (17, 33, 3)  # PIL reads it, smoothed
    with pytest.raises(NotImplementedError, match="prog.jpg: progressive JPEG whose scans leave AC "
                                                  "coefficients 1-9 unfinished"):
        tfu.read_gen(p)


def test_jpeg_refuses_411(tmp_path):
    """4:1:1 decodes (`tests/test_torch_formats.py`); sampling factors whose
    ratios are not whole numbers, which libjpeg refuses too, are refused by
    name (4:1:1's chroma factors rewritten to 3x1 and 2x1)."""
    p = _jpeg_cv2(str(tmp_path / "s411.jpg"), _texture(np.random.RandomState(2), (17, 33, 3)),
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)
    _check_jpeg(p)
    data = bytearray(open(p, "rb").read())
    sof = data.index(b"\xff\xc0")
    assert data[sof + 11:sof + 20:3] == b"\x41\x11\x11"
    data[sof + 14], data[sof + 17] = 0x31, 0x21
    with open(p, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(OSError):
        jfu.read_gen(p)
    with pytest.raises(NotImplementedError, match="s411.jpg.*sampling factors 4x1,3x1,2x1"):
        tfu.read_gen(p)


# ------------------------------------------------------------------ fuzz

_FUZZ = r"""
import sys, zlib, numpy as np
sys.path.insert(0, {root!r})
from anystereo_tpu_torch.data.jpeg import decode_jpeg
from anystereo_tpu_torch.data import png

kind, path = sys.argv[1], sys.argv[2]
data = open(path, "rb").read()
rng = np.random.RandomState(1234)
outcomes = {{}}

def mutants(data, n):
    for i in range(n):
        b = bytearray(data)
        if i % 2:  # flip 1-4 bytes
            for _ in range(rng.randint(1, 5)):
                b[rng.randint(len(b))] ^= rng.randint(1, 256)
        else:
            b = b[:rng.randint(len(b))]
        yield bytes(b)

def sof_shape(b):
    pos = 2
    while pos + 4 <= len(b):
        if b[pos] != 0xFF:
            return None
        m, n = b[pos + 1], (b[pos + 2] << 8) | b[pos + 3]
        if m in (0xC0, 0xC1):
            h, w, c = (b[pos + 5] << 8) | b[pos + 6], (b[pos + 7] << 8) | b[pos + 8], b[pos + 9]
            return (h, w, 3) if c == 3 else (h, w)
        pos += 2 + n
    return None

if kind == "jpeg":
    for b in mutants(data, 120):
        try:
            out = decode_jpeg(b, "fuzz.jpg")
        except (ValueError, NotImplementedError) as e:
            outcomes[type(e).__name__] = outcomes.get(type(e).__name__, 0) + 1
            continue
        assert out.shape == sof_shape(b), (out.shape, sof_shape(b))
        outcomes["decoded"] = outcomes.get("decoded", 0) + 1
else:  # the filtered stream of a PNG (what the C unfilter reads)
    h, w, bpp = 23, 37, 3
    for b in mutants(data, 120):
        raw = np.frombuffer(b, np.uint8)
        if raw.size != h * (w * bpp + 1):
            outcomes["size"] = outcomes.get("size", 0) + 1
            continue
        try:
            out = png._unfilter_c(raw, h, w * bpp, bpp)
        except ValueError:
            outcomes["ValueError"] = outcomes.get("ValueError", 0) + 1
            continue
        assert out.shape == (h, w * bpp)
        np.testing.assert_array_equal(out, png._unfilter_numpy(raw, h, w * bpp, bpp))
        outcomes["decoded"] = outcomes.get("decoded", 0) + 1
print(outcomes)
"""


@pytest.mark.parametrize("kind", ["png", "jpeg"])
def test_fuzzed_streams_never_crash(tmp_path, kind):
    """120 seeded truncations and byte flips of a filtered PNG stream and of
    a JPEG file (4:2:0, restart interval 2): each raises ValueError or
    NotImplementedError or gives an array of the header's shape (a PNG
    stream the same array as the plain version).  In a subprocess, so that
    a crash fails this test and not the worker."""
    rng = np.random.RandomState(3)
    p = str(tmp_path / "fuzz.bin")
    if kind == "png":
        arr = _image(rng, 23, 37, 8, 2)
        stream = _png_bytes(arr, 8, 2, list(rng.randint(0, 5, 23)))
        raw = zlib.decompress(stream[stream.index(b"IDAT") + 4:stream.index(b"IEND") - 8])
        with open(p, "wb") as f:
            f.write(raw)
    else:
        _jpeg_cv2(p, _texture(rng, (21, 33, 3)), cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)
    out = subprocess.run([sys.executable, "-c", _FUZZ.format(root=str(ROOT)), kind, p],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, (out.returncode, out.stderr[-2000:])
    outcomes = eval(out.stdout.strip().splitlines()[-1])  # noqa: S307 - the dict the script printed
    assert sum(outcomes.values()) == 120 and len(outcomes) >= 2, outcomes


# --------------------------------------------------------------- threads


def test_four_threads_decode_at_once(tmp_path):
    """Four threads decoding PNGs and JPEGs at once give the arrays one
    thread gives (the C code keeps no global state)."""
    rng = np.random.RandomState(6)
    paths = []
    for i in range(4):
        arr = _texture(rng, (120, 200, 3), sigma=1.2)
        paths.append(_jpeg_pil(str(tmp_path / f"{i}.jpg"), arr, quality=90, subsampling=i % 3))
        p = str(tmp_path / f"{i}.png")
        write_png(p, arr, filter_type=(3, 4)[i % 2])
        paths.append(p)
    want = [tfu.read_gen(p) for p in paths]
    got, errors = {}, []

    def work(k):
        try:
            for rep in range(5):
                for j, p in enumerate(paths):
                    got[(k, rep, j)] = tfu.read_gen(p)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(got) == 4 * 5 * len(paths)
    for (_, _, j), arr in got.items():
        np.testing.assert_array_equal(arr, want[j])


def test_first_use_from_many_threads_builds_once(tmp_path, monkeypatch):
    """Sixteen threads reading at once before anything is built (the
    loader's first batch): one build of each source, every array right."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_LIBS", {})
    rng = np.random.RandomState(11)
    arr = _texture(rng, (40, 60, 3))
    png_path, jpg_path = str(tmp_path / "a.png"), _jpeg_pil(str(tmp_path / "a.jpg"), arr)
    write_png(png_path, arr, filter_type=4)
    want = {png_path: arr, jpg_path: jfu.read_gen(jpg_path)}
    builds, own_build = [], build.build

    def counted_build(names=None):
        out = own_build(names)
        builds.extend(out)
        return out

    monkeypatch.setattr(build, "build", counted_build)
    results, errors = [], []

    def work(k):
        try:
            p = (png_path, jpg_path)[k % 2]
            results.append((p, tfu.read_gen(p)))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert sorted(builds) == ["jpeg_decode", "png_unfilter"]
    assert len(results) == 16
    for p, got in results:
        np.testing.assert_array_equal(got, want[p])


# ----------------------------------------------------------- no fallback


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_missing_compiler_raises(tmp_path, monkeypatch, ext):
    """With no C compiler and nothing built, the readers raise and name the
    compiler searched and the source; they do not fall back to numpy."""
    p = str(tmp_path / f"a.{ext}")
    arr = _texture(np.random.RandomState(0), (9, 11, 3))
    if ext == "png":
        write_png(p, arr, filter_type=4)
    else:
        _jpeg_pil(p, arr)
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_LIBS", {})
    source = "png_unfilter.c" if ext == "png" else "jpeg_decode.c"
    with pytest.raises(RuntimeError, match=f"no host C compiler to build .*{source}.*no-such-cc"):
        tfu.read_gen(p)
    assert not (tmp_path / "kernels").exists() or not any((tmp_path / "kernels").iterdir())


def test_c_sources_build_with_the_host_compiler(tmp_path, monkeypatch):
    """Both C sources compile in a fresh build directory, keyed by the
    compiler's path; a second build reuses them."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_LIBS", {})
    assert sorted(build.build(["png_unfilter", "jpeg_decode"])) == ["jpeg_decode", "png_unfilter"]
    assert build.build(["png_unfilter", "jpeg_decode"]) == {}
    path = build.library_path("jpeg_decode")
    assert path.exists() and path.parent == tmp_path / "kernels"
    other = tmp_path / "other-cc"  # the same compiler under another path
    other.symlink_to(build._cc(path))
    monkeypatch.setenv("CC", str(other))
    assert build.library_path("jpeg_decode") != path


# --------------------------------------------------------------- fixtures


def write_jpeg_fixtures(out: Path = FIXTURES) -> None:
    """Write the committed JPEGs and the digests of PIL's decode of them."""
    import PIL
    import PIL.features

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(7)
    small = _texture(rng, (21, 33, 3))
    for name, sub in SUBSAMPLING.items():
        _jpeg_pil(str(out / f"small_{name}.jpg"), small, quality=90, subsampling=sub)
    _jpeg_cv2(str(out / "small_440.jpg"), small, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440, cv2.IMWRITE_JPEG_QUALITY, 90)
    _jpeg_cv2(str(out / "small_420_rst.jpg"), small, cv2.IMWRITE_JPEG_RST_INTERVAL, 1)
    _jpeg_pil(str(out / "small_gray.jpg"), _texture(rng, (17, 33)), quality=90)
    left, right, _ = chip_smoke._stereo_pair(np, np.random.RandomState(STEREO_SEED), 540, 960, 8.0, 60.0)
    _jpeg_pil(str(out / "stereo.left.jpg"), left)  # PIL's defaults: quality 75, 4:2:0
    _jpeg_pil(str(out / "stereo.right.jpg"), right)
    with open(out / "digests.json", "w") as f:
        json.dump(_digests(out) | {"made_by": {
            "Pillow": PIL.__version__, "libjpeg": PIL.features.version("jpg"),
            "libjpeg_turbo": PIL.features.version("libjpeg_turbo")},
            "stereo": {"seed": STEREO_SEED, "dmin": 8.0, "dmax": 60.0,
                       "made_by": "chip_smoke._stereo_pair"}}, f, indent=1, sort_keys=True)
        f.write("\n")


def _digests(folder: Path) -> dict:
    files = {}
    for p in sorted(folder.glob("*.jpg")):
        a = np.array(Image.open(p))
        files[p.name] = {"shape": list(a.shape), "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return {"files": files}


def test_jpeg_fixture_digests_are_pils():
    """The recorded digests are PIL's decode of the committed files, the
    files cover every supported subsampling and the 540x960 pair, and the C
    decoder gives them."""
    record = json.loads((FIXTURES / "digests.json").read_text())
    assert record["files"] == _digests(FIXTURES)["files"]
    assert {"small_444.jpg", "small_422.jpg", "small_420.jpg", "small_440.jpg", "small_gray.jpg",
            "stereo.left.jpg", "stereo.right.jpg"} <= set(record["files"])
    assert record["files"]["stereo.left.jpg"]["shape"] == [540, 960, 3]
    assert sum(os.path.getsize(p) for p in FIXTURES.iterdir()) < 320_000
    for name, want in record["files"].items():
        got = read_jpeg(str(FIXTURES / name))
        assert list(got.shape) == want["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"], name
