"""The port's image readers against the JAX package's, for every PNG, JPEG
and PPM form they read: `anystereo_tpu_torch.data.frame_utils.read_gen`
against `anystereo_tpu.data.frame_utils.read_gen` (PIL's
`np.array(Image.open(path))`), `read_disp_kitti` against the JAX one
(`cv2.imread(path, cv2.IMREAD_ANYDEPTH)`), and the KITTI and Middlebury
occlusion providers of both `eval/validate.py` (PIL, and PIL's
`convert("L")`).  The files are made here: by PIL and OpenCV where they
write the form (progressive, CMYK and 4:1:1 JPEGs, PNG bitmaps), by the
small numpy writers below for the rest (every PNG colour type and depth,
Adam7, `tRNS`, every Netpbm type and maxval), and by `tests/jpeg_writers.py`
for arithmetic-coded and lossless JPEGs (`tests/test_torch_reader_forms.py`
holds those forms, EXIF and OpenCV's gray decodes).

Tolerances: none.  Every array equals its reference in shape, dtype and
bytes, and the PNG C unfilter equals its numpy plain version on every file.

The fixtures under `tests/data/formats/` (read on the card's host, which
has no PIL) are written by `write_format_fixtures()`:

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python -c "import tests.conftest, \\
        test_torch_formats as t; t.write_format_fixtures()"

and `test_format_fixture_digests_are_pils` holds their recorded digests to
PIL's decode of the committed files, `test_format_fixture_opencv_digests`
the JAX package's `read_disp_kitti` ones (OpenCV's) to cv2's.
"""

import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import types
import zlib
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
from PIL import Image  # noqa: E402

from anystereo_tpu.data import frame_utils as jfu  # noqa: E402
from anystereo_tpu.eval import validate as jval  # noqa: E402
from anystereo_tpu_torch.data import frame_utils as tfu  # noqa: E402
from anystereo_tpu_torch.data import png as tpng  # noqa: E402
from anystereo_tpu_torch.eval import validate as tval  # noqa: E402
from jpeg_writers import PROGRESSION, arith_jpeg, lossless_jpeg, random_blocks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "formats"
FIXTURE_CAP = 300_000  # bytes of the whole folder
OPENCV_DIGESTS = "opencv_digests.json"  # the JAX package's read_disp_kitti (cv2's) of the fixtures
NEW_FORMS = {"small_progressive_cut.jpg", "small_progressive_dc_only.jpg", "small_arith_sof9.jpg",
             "small_arith_sof10.jpg", "small_lossless_gray.jpg", "small_lossless_rgb.jpg", "small_c2d8_srgb.png",
             "small_c2d16_gama.png", "small_c6d16_gama_sbit.png", "small_c0d16_exif6.png", "disp_gray.jpg",
             "disp_exif8.jpg"}
STEREO_SEED = 15  # `chip_smoke._stereo_pair` seed of the 540x960 pair
SIZES = [(1, 1), (1, 9), (5, 3), (7, 7), (13, 17)]
PNG_TYPES = [(colour, depth) for colour, depths in tpng._DEPTHS.items() for depth in depths]


def _texture(rng, shape, dtype=np.uint8):
    from scipy.ndimage import gaussian_filter

    x = gaussian_filter(rng.rand(*shape), 1.0)
    x = (x - x.min()) / max(float(x.max() - x.min()), 1e-9)
    return (x * np.iinfo(dtype).max).astype(dtype)


def _same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert (got.dtype, got.shape) == (want.dtype, want.shape), what
    np.testing.assert_array_equal(got, want, err_msg=what)
    assert got.tobytes() == want.tobytes(), what  # PIL's bool arrays hold 0 and 255


def _check(path):
    """read_gen of the port against the JAX package's; for a PNG also the
    C unfilter against the numpy one."""
    _same(tfu.read_gen(path), jfu.read_gen(path), path)
    if tfu._format(path) == "png":
        _same(tpng.decode_png(path, "c").samples, tpng.decode_png(path, "numpy").samples, path)


# ------------------------------------------------------------- writers


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def _rows(samples, depth):
    """[h, w, c] samples -> [h, row_bytes] uint8, big-endian at 16 bits,
    packed MSB first below 8 with the padding bits of each row set (a
    reader must drop them)."""
    h, w, c = samples.shape
    if depth == 16:
        return np.ascontiguousarray(samples.astype(">u2")).view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    bits = (samples[..., 0, None].astype(np.uint8) >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1
    bits = bits.reshape(h, w * depth)
    pad = -(w * depth) % 8
    return np.packbits(np.concatenate([bits, np.ones((h, pad), np.uint8)], axis=1), axis=1)


def write_png_any(path, samples, depth, colour, interlace=0, palette=None, extra=b"", seed=0):
    """A PNG of `samples` ([H, W, samples a pixel], raw values) at any colour
    type and depth, Adam7-interlaced if asked, each row (of each pass)
    filtered by a seeded filter type; `palette` [n, 3] uint8 for colour
    type 3; `extra` chunks (tRNS, gAMA) before the image data."""
    rng = np.random.RandomState(seed)
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    stream = []
    for x0, y0, dx, dy in tpng._ADAM7 if interlace else [(0, 0, 1, 1)]:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _rows(sub, depth)
        kinds = rng.randint(0, 5, rows.shape[0])
        by_kind = [tpng._filter(rows, bpp, k) for k in range(5)]
        filt = np.stack([by_kind[k][r] for r, k in enumerate(kinds)])
        stream.append(np.concatenate([kinds.astype(np.uint8)[:, None], filt], axis=1).tobytes())
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    body = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
    if palette is not None:
        body += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    body += extra + _chunk(b"IDAT", zlib.compress(b"".join(stream))) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(body)
    return path


def _png_case(rng, h, w, colour, depth):
    """Samples and a palette for one PNG: a texture at 8 and 16 bits, random
    values below 8 and for the indices, a palette shorter than the index
    range at 8 bits (PIL and libpng read the missing entries as black)."""
    c = tpng._CHANNELS[colour]
    if depth >= 8 and colour != 3:
        samples = _texture(rng, (h, w, c), np.uint16 if depth == 16 else np.uint8)
    else:
        samples = rng.randint(0, 1 << depth, (h, w, c)).astype(np.uint8)
    palette = rng.randint(0, 256, (min(1 << depth, 200), 3)) if colour == 3 else None
    return samples, palette


def _write_ppm(path, magic, values, maxval):
    """A Netpbm file with comments in its header and (plain) body; values
    [H, W] or [H, W, 3] raw."""
    h, w = values.shape[:2]
    head = magic.encode() + b"\n# a comment\n%d %d\n" % (w, h)
    if magic in ("P1", "P4"):
        if magic == "P1":
            body = b"".join(b"".join(b"%d" % v for v in row) + b"\n" for row in values)
        else:
            body = np.packbits(values.astype(np.uint8), axis=1).tobytes()
        data = head + body
    else:
        head += b"%d\n" % maxval
        if magic in ("P2", "P3"):
            rows = (b" ".join(b"%d" % v for v in row.ravel()) for row in values)
            body = b"# values\n" + b"\n".join(rows) + b"\n"
        else:
            body = values.astype(">u2" if maxval > 255 else np.uint8).tobytes()
        data = head + body
    with open(path, "wb") as f:
        f.write(data)
    return path


def _pil_jpeg(path, arr, **kw):
    if arr.ndim == 3 and arr.shape[2] == 4:
        img = Image.frombytes("CMYK", arr.shape[1::-1], np.ascontiguousarray(arr).tobytes())
    else:
        img = Image.fromarray(arr)
    img.save(path, "JPEG", **kw)
    return path


def _cv2_jpeg(path, arr, *params):
    ok, enc = cv2.imencode(".jpg", arr[..., ::-1] if arr.ndim == 3 else arr, list(params))
    assert ok
    with open(path, "wb") as f:
        f.write(enc.tobytes())
    return path


def _markers(data):
    """(marker, start) of every marker segment of a JPEG up to the EOI, an
    SOS with its entropy-coded data."""
    out, pos = [], 2
    while pos < len(data) - 1:
        marker = data[pos + 1]
        out.append((marker, pos))
        if marker == 0xD9:
            break
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xDA:
            while not (data[pos] == 0xFF and data[pos + 1] not in (0,) + tuple(range(0xD0, 0xD8))):
                pos += 1
    return out


# ----------------------------------------------------------------- PNG


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("colour,depth", PNG_TYPES, ids=[f"c{c}d{d}" for c, d in PNG_TYPES])
def test_png_every_type(tmp_path, colour, depth, interlace):
    """Every colour type and depth the PNG specification allows, plain and
    Adam7 (passes empty at sizes under 8), odd sizes and 1x1: PIL's array
    through read_gen, OpenCV's through read_disp_kitti, PIL's
    `convert("L")`, C unfilter equal to numpy."""
    rng = np.random.RandomState(colour * 100 + depth * 2 + interlace)
    for h, w in SIZES + [(19, 37)]:
        samples, palette = _png_case(rng, h, w, colour, depth)
        p = write_png_any(str(tmp_path / f"{h}x{w}.png"), samples, depth, colour, interlace, palette,
                          seed=h * w)
        _check(p)
        _same(tfu.read_disp_kitti(p)[0], jfu.read_disp_kitti(p)[0], p)
        _same(tfu.read_disp_kitti(p)[1], jfu.read_disp_kitti(p)[1], p)
        _same(tfu.read_luminance(p), np.asarray(Image.open(p).convert("L")), p)


@pytest.mark.filterwarnings("ignore:Palette images with Transparency expressed in bytes")
@pytest.mark.parametrize("colour,depth", [(0, 1), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 2), (3, 8)])
def test_png_trns_changes_no_mode(tmp_path, colour, depth):
    """A tRNS chunk leaves PIL's mode as it is (its transparency goes into
    `info`): the array with it equals the array without it, and the port's."""
    rng = np.random.RandomState(depth)
    samples, palette = _png_case(rng, 9, 11, colour, depth)
    trns = {0: struct.pack(">H", 1), 2: struct.pack(">HHH", 1, 2, 3), 3: bytes([0, 128, 255])}[colour]
    plain = write_png_any(str(tmp_path / "plain.png"), samples, depth, colour, 0, palette)
    p = write_png_any(str(tmp_path / "trns.png"), samples, depth, colour, 1, palette, _chunk(b"tRNS", trns))
    assert "transparency" in Image.open(p).info
    _same(jfu.read_gen(p), jfu.read_gen(plain))
    _check(p)
    _same(tfu.read_disp_kitti(p)[0], jfu.read_disp_kitti(p)[0])
    _same(tfu.read_luminance(p), np.asarray(Image.open(p).convert("L")))


def test_the_four_faults(tmp_path):
    """The arrays the port gave wrongly before: 16-bit RGB (PIL keeps the
    high byte), 16-bit gray+alpha (PIL gives RGBA), a P5 PGM at maxval
    65535 (int32, mode "I") and a P6 PPM at maxval 65535 (scaled to 0-255)."""
    rng = np.random.RandomState(22)
    rgb16 = _texture(rng, (5, 7, 3), np.uint16)
    la16 = _texture(rng, (5, 7, 2), np.uint16)
    files = {"rgb16.png": write_png_any(str(tmp_path / "rgb16.png"), rgb16, 16, 2),
             "la16.png": write_png_any(str(tmp_path / "la16.png"), la16, 16, 4),
             "p5.ppm": _write_ppm(str(tmp_path / "p5.ppm"), "P5", rng.randint(0, 65536, (5, 7)), 65535),
             "p6.ppm": _write_ppm(str(tmp_path / "p6.ppm"), "P6", rng.randint(0, 65536, (5, 7, 3)), 65535)}
    want = {"rgb16.png": (rgb16 >> 8).astype(np.uint8),
            "la16.png": (la16 >> 8).astype(np.uint8)[..., [0, 0, 0, 1]]}
    for name, p in files.items():
        _check(p)
        if name in want:
            _same(tfu.read_gen(p), want[name])
    assert tfu.read_gen(files["p5.ppm"]).dtype == np.int32
    assert tfu.read_gen(files["p6.ppm"]).dtype == np.uint8


def test_opencv_gamma_refused_by_name(tmp_path):
    """libpng turns colour gray through its gamma tables when a gAMA (other
    than 1.0) or sRGB chunk is there, so OpenCV's array differs from the
    one without the chunk; the port's KITTI reader, which refused such a
    file by name until libpng's tables were ported, gives OpenCV's array
    (`tests/test_torch_reader_forms.py` holds every colour type, depth and
    chunk form); PIL's readers ignore the chunk."""
    samples = _texture(np.random.RandomState(3), (6, 9, 3))
    plain = write_png_any(str(tmp_path / "plain.png"), samples, 8, 2)
    unit = write_png_any(str(tmp_path / "unit.png"), samples, 8, 2,
                         extra=_chunk(b"gAMA", struct.pack(">I", 100000)))
    _same(tfu.read_disp_kitti(unit)[0], jfu.read_disp_kitti(unit)[0])
    for kind, body in ((b"gAMA", struct.pack(">I", 45455)), (b"sRGB", b"\0")):
        p = write_png_any(str(tmp_path / f"{kind.decode()}.png"), samples, 8, 2, extra=_chunk(kind, body))
        assert not np.array_equal(jfu.read_disp_kitti(p)[0], jfu.read_disp_kitti(plain)[0])
        _same(tfu.read_disp_kitti(p)[0], jfu.read_disp_kitti(p)[0], p)
        _check(p)
        _same(tfu.read_luminance(p), np.asarray(Image.open(p).convert("L")))


@pytest.mark.parametrize("colour,depth", [(0, 8), (0, 16), (2, 8), (2, 16), (0, 1), (3, 4), (4, 16), (6, 8)])
def test_occlusion_providers(tmp_path, colour, depth):
    """The KITTI provider (disp_occ against disp_noc as PIL reads them) and
    the Middlebury one (mask0nocc.png's `convert("L")` == 255) give the JAX
    package's masks."""
    rng = np.random.RandomState(colour + depth)
    for interlace in (0, 1):
        samples, palette = _png_case(rng, 11, 13, colour, depth)
        other = samples.copy()
        other[:, :4] = 0
        for sub, arr in (("disp_occ_0", samples), ("disp_noc_0", other)):
            os.makedirs(tmp_path / sub, exist_ok=True)
            write_png_any(str(tmp_path / sub / "000000_10.png"), arr, depth, colour, interlace, palette)
        kitti = types.SimpleNamespace(disparity_list=[str(tmp_path / "disp_occ_0" / "000000_10.png")])
        _same(tval.kitti_occ_provider(kitti, 0), jval.kitti_occ_provider(kitti, 0))
        write_png_any(str(tmp_path / "mask0nocc.png"), samples, depth, colour, interlace, palette)
        mb = types.SimpleNamespace(disparity_list=[str(tmp_path / "disp0GT.pfm")])
        _same(tval.nocc_mask_occ_provider(mb, 0), jval.nocc_mask_occ_provider(mb, 0))


@pytest.mark.parametrize("kind", ["palette", "palette 8-bit", "bitmap", "16-bit"])
def test_middlebury_masks_as_image_tools_save_them(tmp_path, kind):
    """mask0nocc.png as image tools save a black-and-white mask: a palette
    PNG whose index 1 is white (at 1 bit, PIL's choice for 2 colours, and
    at 8), a 1-bit PNG, a 16-bit PNG at 65535.  PIL's `convert("L")` makes
    white 255, so those pixels are not occluded."""
    white = np.random.RandomState(6).rand(12, 16) < 0.7
    mask = str(tmp_path / "mask0nocc.png")
    if kind.startswith("palette"):
        img = Image.fromarray(white.astype(np.uint8)).convert("P")
        img.putpalette([0, 0, 0, 255, 255, 255])
        img.save(mask, **({"bits": 8} if kind.endswith("8-bit") else {}))
    elif kind == "bitmap":
        Image.fromarray(white).save(mask)
    else:
        Image.fromarray((white * 65535).astype(np.uint16)).save(mask)
    with open(mask, "rb") as f:
        depth = f.read(25)[24]
    modes = {"palette": ("P", 1), "palette 8-bit": ("P", 8), "bitmap": ("1", 1), "16-bit": ("I;16", 16)}
    assert (Image.open(mask).mode, depth) == modes[kind]
    mb = types.SimpleNamespace(disparity_list=[str(tmp_path / "disp0GT.pfm")])
    want = jval.nocc_mask_occ_provider(mb, 0)
    _same(want, ~white)
    _same(tval.nocc_mask_occ_provider(mb, 0), want)


# ----------------------------------------------------------------- PPM

PPM_CASES = [("P1", 1), ("P4", 1)] + [(m, v) for m in ("P2", "P3", "P5", "P6")
                                      for v in (1, 15, 255, 256, 1000, 65535)]


@pytest.mark.parametrize("magic,maxval", PPM_CASES, ids=[f"{m}-{v}" for m, v in PPM_CASES])
def test_ppm_every_type(tmp_path, magic, maxval):
    """P1-P6 at maxvals 1 to 65535, with comments: PIL's mode and values
    (bool bitmaps; uint8, or int32 for graymaps past 255; scaled, half to
    even), and its `convert("L")`."""
    rng = np.random.RandomState(maxval + int(magic[1]))
    bands = 3 if magic in ("P3", "P6") else 1
    for h, w in SIZES:
        values = rng.randint(0, maxval + 1, (h, w, bands) if bands == 3 else (h, w))
        p = _write_ppm(str(tmp_path / f"{h}x{w}.ppm"), magic, values, maxval)
        _check(p)
        _same(tfu.read_luminance(p), np.asarray(Image.open(p).convert("L")), p)


def test_ppm_header_forms(tmp_path):
    """Header forms PIL reads: a comment inside a token, tabs, no space
    after a plain bitmap's pixels, a raw value above maxval (clipped)."""
    files = {"inside.ppm": b"P5\n1#c\n2 1\n255\n" + bytes(range(12)),
             "tabs.ppm": b"P2\t3\t1\t9 0 9 4",
             "packed.ppm": b"P1 3 2 010110",
             "above.ppm": b"P5 2 1 7\n" + bytes([3, 200])}
    for name, data in files.items():
        p = tmp_path / name
        p.write_bytes(data)
        _check(str(p))


# ---------------------------------------------------------------- JPEG

SUBSAMPLING = {"444": 0, "422": 1, "420": 2, "gray": None}


@pytest.mark.parametrize("subsampling", list(SUBSAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_progressive_pil(tmp_path, quality, subsampling):
    """Progressive files as PIL writes them (libjpeg's default script:
    DC first and refine scans, AC spectral bands and refinements, a DHT
    before each scan), with and without optimised tables."""
    rng = np.random.RandomState(quality)
    for h, w in SIZES + [(17, 33)]:
        for optimize in (False, True):
            arr = _texture(rng, (h, w) if subsampling == "gray" else (h, w, 3))
            kw = {} if subsampling == "gray" else {"subsampling": SUBSAMPLING[subsampling]}
            p = _pil_jpeg(str(tmp_path / f"{h}x{w}.jpg"), arr, quality=quality, progressive=True,
                          optimize=optimize, **kw)
            marks = [m for m, _ in _markers(open(p, "rb").read())]
            assert 0xC2 in marks and 0xC4 in marks[marks.index(0xDA):]  # a DHT between scans
            _check(p)
            _same(tfu.read_luminance(p), np.asarray(Image.open(p).convert("L")), p)


SAMPLING = {"411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "gray": None}


@pytest.mark.parametrize("interval", [0, 1, 3])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_opencv_progressive_and_411(tmp_path, sampling, interval):
    """OpenCV's progressive files with restart intervals (a restart resets
    the EOB run and the DC predictions), every sampling layout it writes,
    4:1:1 (box upsampled by 4) baseline and progressive."""
    rng = np.random.RandomState(interval)
    for h, w in SIZES + [(21, 35)]:
        gray = sampling == "gray"
        arr = _texture(rng, (h, w) if gray else (h, w, 3))
        params = [cv2.IMWRITE_JPEG_RST_INTERVAL, interval, cv2.IMWRITE_JPEG_QUALITY, 80]
        if not gray:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
        for progressive in (1, 0):
            p = _cv2_jpeg(str(tmp_path / f"{h}x{w}.jpg"), arr, *params, cv2.IMWRITE_JPEG_PROGRESSIVE,
                          progressive)
            _check(p)


@pytest.mark.parametrize("transform", [None, 0, 1, 2])
@pytest.mark.parametrize("progressive", [False, True])
def test_cmyk_and_ycck(tmp_path, progressive, transform):
    """Four components as Pillow writes them (an Adobe marker, transform 0:
    CMYK) and with the marker's transform rewritten: 2 is YCCK, 1 is taken
    as YCCK too, and no marker is CMYK; PIL inverts every sample."""
    rng = np.random.RandomState(int(progressive) + 10 * (transform or 0))
    for h, w in SIZES + [(17, 33)]:
        p = _pil_jpeg(str(tmp_path / f"{h}x{w}.jpg"), _texture(rng, (h, w, 4)), quality=85,
                      progressive=progressive)
        data = bytearray(open(p, "rb").read())
        adobe = data.index(b"Adobe")
        if transform is None:
            start = adobe - 4
            data = data[:start] + data[start + 2 + struct.unpack(">H", data[start + 2:start + 4])[0]:]
        else:
            data[adobe + 11] = transform
        with open(p, "wb") as f:
            f.write(bytes(data))
        assert jfu.read_gen(p).shape == (h, w, 4)
        _check(p)
        _same(tfu.read_luminance(p), np.asarray(Image.open(p).convert("L")), p)


def test_progressive_without_its_last_dc_refinement(tmp_path):
    """The DC refinement scan moved to the end and cut off (a legal order):
    every AC coefficient is final, so libjpeg does not smooth, and the DC
    keeps its missing low bit."""
    p = _pil_jpeg(str(tmp_path / "dc.jpg"), _texture(np.random.RandomState(5), (23, 41, 3)), quality=85,
                  progressive=True)
    data = open(p, "rb").read()
    marks = _markers(data)
    groups, start = [], None  # (start, end) of each scan with the DHTs before it
    for (m, pos), (_, end) in zip(marks, marks[1:]):
        start = pos if start is None and m in (0xC4, 0xDA) else start
        if m == 0xDA:
            groups.append((start, end))
            start = None
    refine = [g for g in groups if _scan_params(data, g)[0] == 0 and _scan_params(data, g)[2] > 0]
    assert len(refine) == 1
    with open(p, "wb") as f:
        f.write(data[:groups[0][0]] + b"".join(data[a:b] for a, b in groups if (a, b) != refine[0]) +
                b"\xff\xd9")
    assert not np.array_equal(jfu.read_gen(p), np.array(Image.open(io.BytesIO(data))))
    _check(p)


def _scan_params(data, group):
    """(Ss, Se, Ah, Al) of the SOS in the byte range `group`."""
    sos = data.index(b"\xff\xda", group[0])
    ns = data[sos + 4]
    ss, se, a = data[sos + 5 + 2 * ns:sos + 8 + 2 * ns]
    return ss, se, a >> 4, a & 15


@pytest.mark.parametrize("kind", ["420", "444", "gray"])
def test_files_without_huffman_tables(tmp_path, kind):
    """A baseline file whose DHT segments are taken out (as Motion-JPEG
    frames leave out the standard tables): libjpeg-turbo decodes with the
    standard tables of annex K.3, and so does the port."""
    arr = _texture(np.random.RandomState(7), (19, 27) if kind == "gray" else (19, 27, 3))
    kw = {} if kind == "gray" else {"subsampling": SUBSAMPLING[kind]}
    p = _pil_jpeg(str(tmp_path / "m.jpg"), arr, quality=70, **kw)
    data = open(p, "rb").read()
    marks = _markers(data)
    cut = b"".join(data[pos:marks[i + 1][1]] for i, (m, pos) in enumerate(marks[:-1]) if m != 0xC4)
    with open(p, "wb") as f:
        f.write(data[:2] + cut + b"\xff\xd9")
    assert b"\xff\xc4" not in open(p, "rb").read()
    _check(p)


def _rewrite_sof(data, marker=None, precision=None, ncomp=None, height=None):
    data = bytearray(data)
    sof = next(pos for m, pos in _markers(bytes(data)) if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC))
    if marker is not None:
        data[sof + 1] = marker
    if precision is not None:
        data[sof + 4] = precision
    if height is not None:
        data[sof + 5:sof + 7] = struct.pack(">H", height)
    if ncomp is not None:
        data[sof + 9] = ncomp
    return bytes(data)


REFUSED = {
    "SOF3 lossless": (dict(marker=0xC3), "lossless JPEG in YCbCr"),
    "SOF11 arithmetic": (dict(marker=0xCB), "arithmetic-coded lossless JPEG \\(SOF11\\)"),
    "SOF5 hierarchical": (dict(marker=0xC5), "hierarchical \\(differential\\) JPEG \\(SOF5\\)"),
    "12-bit": (dict(precision=12), "12-bit JPEG samples"),
    "2 components": (dict(ncomp=2), "JPEG with 2 components"),
    "height from a DNL marker": (dict(height=0), "image height given by a DNL marker"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refusals_name_their_form(tmp_path, case):
    """What the port does not decode raises NotImplementedError naming the
    file and the form, and PIL refuses each too: a lossless frame in YCbCr
    (this file's JFIF marker; libjpeg converts no colour in lossless mode),
    an arithmetic-coded lossless one, a hierarchical one, a height left to a
    DNL marker; PIL reads 8-bit samples and 1, 3 or 4 components.  (Arithmetic-coded SOF9 and SOF10
    files decode: `tests/test_torch_reader_forms.py`.)"""
    p = _pil_jpeg(str(tmp_path / "r.jpg"), _texture(np.random.RandomState(1), (9, 17, 3)), progressive=True)
    kw, pattern = REFUSED[case]
    data = _rewrite_sof(open(p, "rb").read(), **kw)
    with open(p, "wb") as f:
        f.write(data)
    with pytest.raises((OSError, SyntaxError)):
        jfu.read_gen(p)
    with pytest.raises(NotImplementedError, match=f"r.jpg: .*{pattern}"):
        tfu.read_gen(p)


def test_smoothing_refused_by_name(tmp_path):
    """A progressive file cut after any of its scans but the last leaves AC
    coefficients 1-9 unfinished: libjpeg smooths such blocks and PIL reads
    it.  The port refused it by name until libjpeg's block smoothing was
    ported; it now gives PIL's array for every cut."""
    p = _pil_jpeg(str(tmp_path / "cut.jpg"), _texture(np.random.RandomState(2), (17, 33, 3)),
                  progressive=True)
    data = open(p, "rb").read()
    scans = [pos for m, pos in _markers(data) if m == 0xDA]
    for k in range(1, len(scans)):
        with open(p, "wb") as f:
            f.write(data[:scans[k]] + b"\xff\xd9")
        assert jfu.read_gen(p).shape == (17, 33, 3)
        _check(p)


def test_disparity_that_is_no_png_refused_by_name(tmp_path):
    """OpenCV reads a JPEG under any name; the port refused a disparity map
    that is no PNG until OpenCV's gray decode was ported, and now gives
    OpenCV's array (libjpeg's Y plane)."""
    p = _pil_jpeg(str(tmp_path / "000000_10.png"), _texture(np.random.RandomState(3), (9, 13)))
    assert jfu.read_disp_kitti(p)[0].shape == (9, 13)
    _same(tfu.read_disp_kitti(p)[0], jfu.read_disp_kitti(p)[0])
    _same(tfu.read_disp_kitti(p)[1], jfu.read_disp_kitti(p)[1])


# --------------------------------------------------- format by content


def test_format_by_content(tmp_path):
    """A file is read by its leading bytes, as PIL's `Image.open` reads it,
    whatever its name says."""
    rng = np.random.RandomState(4)
    arr = _texture(rng, (7, 11, 3))
    png_bytes = open(write_png_any(str(tmp_path / "src.png"), arr, 8, 2), "rb").read()
    jpg_bytes = open(_pil_jpeg(str(tmp_path / "src.jpg"), arr), "rb").read()
    ppm_bytes = open(_write_ppm(str(tmp_path / "src.ppm"), "P6", arr, 255), "rb").read()
    for content, names in ((png_bytes, ("a.jpg", "a.jpeg", "a.ppm")), (jpg_bytes, ("b.png", "b.ppm")),
                           (ppm_bytes, ("c.png", "c.jpg"))):
        for name in names:
            (tmp_path / name).write_bytes(content)
            _check(str(tmp_path / name))


@pytest.mark.parametrize("fmt,found", [("GIF", "a GIF file"), ("BMP", "a BMP file"), ("TIFF", "a TIFF file")])
def test_other_formats_are_named(tmp_path, fmt, found):
    """PIL opens more formats than the port reads; a file of another format
    under a PNG name raises ValueError naming what it found."""
    p = str(tmp_path / "x.png")
    Image.fromarray(_texture(np.random.RandomState(5), (6, 8, 3))).save(p, fmt)
    assert jfu.read_gen(p).shape[:2] == (6, 8)
    with pytest.raises(ValueError, match=f"x.png: not a PNG, JPEG or PPM file \\(found {found}\\)"):
        tfu.read_gen(p)


# ------------------------------------------------------------------ fuzz

_FUZZ = r"""
import sys, numpy as np
sys.path.insert(0, {root!r})
from anystereo_tpu_torch.data.jpeg import decode_jpeg

data = open(sys.argv[1], "rb").read()
rng = np.random.RandomState(int(sys.argv[2]))
outcomes = {{}}

def sof_shape(b):
    pos = 2
    while pos + 10 <= len(b):
        if b[pos] != 0xFF:
            return None
        m, n = b[pos + 1], (b[pos + 2] << 8) | b[pos + 3]
        if m in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
            h, w, c = (b[pos + 5] << 8) | b[pos + 6], (b[pos + 7] << 8) | b[pos + 8], b[pos + 9]
            return (h, w, c) if c > 1 else (h, w)
        pos += 2 + n
    return None

for i in range(150):
    b = bytearray(data)
    if i % 2:
        for _ in range(rng.randint(1, 5)):
            b[rng.randint(len(b))] ^= rng.randint(1, 256)
    else:
        b = b[:rng.randint(len(b))]
    try:
        out = decode_jpeg(bytes(b), "fuzz.jpg")
    except (ValueError, NotImplementedError) as e:
        outcomes[type(e).__name__] = outcomes.get(type(e).__name__, 0) + 1
        continue
    assert out.shape == sof_shape(b), (out.shape, sof_shape(b))
    outcomes["decoded"] = outcomes.get("decoded", 0) + 1
print(outcomes)
"""


@pytest.mark.parametrize("kind", ["progressive 4:2:0 restarts", "progressive CMYK", "4:1:1",
                                  "arithmetic progressive restarts", "lossless restarts", "cut progressive"])
def test_fuzzed_files_never_crash(tmp_path, kind):
    """150 seeded truncations and byte flips of a progressive file with
    restart intervals, a progressive CMYK file, a 4:1:1 file, an
    arithmetic-coded progressive file (SOF10) with restarts and a DAC
    segment, a lossless file (SOF3) with restarts and a progressive file
    cut after its third scan (smoothed): each raises ValueError or
    NotImplementedError or gives an array of the header's shape.  In a
    subprocess, so that a crash fails this test and not the worker."""
    rng = np.random.RandomState(len(kind))
    p = str(tmp_path / "fuzz.jpg")
    if kind == "progressive CMYK":
        _pil_jpeg(p, _texture(rng, (19, 29, 4)), progressive=True)
    elif kind == "4:1:1":
        _cv2_jpeg(p, _texture(rng, (19, 37, 3)), cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["411"])
    elif kind == "arithmetic progressive restarts":
        blocks = [random_blocks(rng, 4, 6), random_blocks(rng, 2, 3), random_blocks(rng, 2, 3)]
        with open(p, "wb") as f:
            f.write(arith_jpeg(21, 33, [(2, 2), (1, 1), (1, 1)], blocks, progressive=True, restart=2,
                               dac={(0, 0): 0x41, (1, 4): 8}, script=PROGRESSION))
    elif kind == "lossless restarts":
        with open(p, "wb") as f:
            f.write(lossless_jpeg([rng.randint(0, 256, (13, 17)).astype(np.uint8) for _ in range(3)],
                                  [(1, 1)] * 3, 5, 1, restart=17))
    elif kind == "cut progressive":
        data = open(_pil_jpeg(p, _texture(rng, (21, 33, 3)), progressive=True), "rb").read()
        with open(p, "wb") as f:
            f.write(data[:[pos for m, pos in _markers(data) if m == 0xDA][3]] + b"\xff\xd9")
    else:
        _cv2_jpeg(p, _texture(rng, (21, 33, 3)), cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                  cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    out = subprocess.run([sys.executable, "-c", _FUZZ.format(root=str(ROOT)), p, str(len(kind))],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, (out.returncode, out.stderr[-2000:])
    outcomes = eval(out.stdout.strip().splitlines()[-1])  # noqa: S307 - the dict the script printed
    assert sum(outcomes.values()) == 150 and len(outcomes) >= 2, outcomes


# -------------------------------------------------------------- fixtures


def _adam7_png(path, arr):
    return write_png_any(path, arr[..., None] if arr.ndim == 2 else arr, 8, 0 if arr.ndim == 2 else 2, 1)


def write_format_fixtures(out: Path = FIXTURES) -> None:
    """Write the committed files of every form and the digests of PIL's
    decode of them."""
    import PIL
    import PIL.features

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    out.mkdir(parents=True, exist_ok=True)
    for old in out.iterdir():
        old.unlink()
    rng = np.random.RandomState(22)
    left, _, _ = chip_smoke._stereo_pair(np, np.random.RandomState(STEREO_SEED), 540, 960, 8.0, 60.0)
    _pil_jpeg(str(out / "stereo.left.progressive.jpg"), left, quality=75, progressive=True)
    small = _texture(rng, (21, 33, 3))
    _pil_jpeg(str(out / "small_cmyk.jpg"), _texture(rng, (21, 33, 4)), quality=90)
    _cv2_jpeg(str(out / "small_411.jpg"), small, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["411"],
              cv2.IMWRITE_JPEG_QUALITY, 90)
    _pil_jpeg(str(out / "small_progressive_gray.jpg"), _texture(rng, (17, 33)), quality=90, progressive=True)
    _cv2_jpeg(str(out / "small_progressive_420_rst.jpg"), small, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
              cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    _adam7_png(str(out / "small_adam7_rgb.png"), small)
    for colour, depth in ((0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 4)):
        samples, palette = _png_case(rng, 13, 19, colour, depth)
        for interlace in (0, 1):
            write_png_any(str(out / f"small_c{colour}d{depth}{'_adam7' if interlace else ''}.png"), samples,
                          depth, colour, interlace, palette)
    for colour in (2, 4, 6):
        samples, _ = _png_case(rng, 13, 19, colour, 16)
        write_png_any(str(out / f"small_c{colour}d16.png"), samples, 16, colour)
    for magic, maxval in (("P1", 1), ("P2", 1000), ("P3", 15), ("P4", 1), ("P5", 65535), ("P6", 65535)):
        bands = 3 if magic in ("P3", "P6") else 1
        values = rng.randint(0, maxval + 1, (9, 13, 3) if bands == 3 else (9, 13))
        _write_ppm(str(out / f"small_{magic}.ppm"), magic, values, maxval)
    _write_new_forms(out, rng)
    with open(out / "digests.json", "w") as f:
        json.dump(_digests(out) | {"made_by": {
            "Pillow": PIL.__version__, "libjpeg_turbo": PIL.features.version("libjpeg_turbo"),
            "zlib": PIL.features.version("zlib")},
            "stereo": {"seed": STEREO_SEED, "dmin": 8.0, "dmax": 60.0, "made_by": "chip_smoke._stereo_pair",
                       "file": "stereo.left.progressive.jpg", "quality": 75}}, f, indent=1, sort_keys=True)
        f.write("\n")
    with open(out / OPENCV_DIGESTS, "w") as f:
        json.dump(_opencv_digests(out) | {"made_by": {"opencv": cv2.__version__}}, f, indent=1, sort_keys=True)
        f.write("\n")


def _write_new_forms(out: Path, rng) -> None:
    """The forms the readers took on last: a progressive file cut after its
    first and third scans (libjpeg smooths it), arithmetic-coded files
    (SOF9 and SOF10, 4:2:0, restarts, a DAC segment), lossless files (SOF3,
    gray and RGB, restarts), colour PNGs with sRGB, gAMA and sBIT chunks,
    a 16-bit gray PNG with an eXIf orientation, and JPEG disparity maps (one
    with an Exif orientation)."""
    from jpeg_writers import segment

    prog = open(_pil_jpeg(str(out / "small_progressive_cut.jpg"), _texture(rng, (21, 33, 3)), quality=90,
                          progressive=True), "rb").read()
    scans = [pos for m, pos in _markers(prog) if m == 0xDA]
    for name, k in (("small_progressive_cut.jpg", 3), ("small_progressive_dc_only.jpg", 1)):
        (out / name).write_bytes(prog[:scans[k]] + b"\xff\xd9")
    blocks = [random_blocks(rng, 4, 6), random_blocks(rng, 2, 3), random_blocks(rng, 2, 3)]
    dac = {(0, 0): 0x52, (0, 1): 0x21, (1, 4): 10, (1, 5): 3}
    for name, progressive in (("small_arith_sof9.jpg", False), ("small_arith_sof10.jpg", True)):
        (out / name).write_bytes(arith_jpeg(21, 33, [(2, 2), (1, 1), (1, 1)], blocks, progressive=progressive,
                                            restart=2, dac=dac, script=PROGRESSION))
    gray = _texture(rng, (17, 23))
    (out / "small_lossless_gray.jpg").write_bytes(lossless_jpeg([gray], [(1, 1)], 7, 1, restart=23))
    rgb = [_texture(rng, (17, 23)) for _ in range(3)]
    (out / "small_lossless_rgb.jpg").write_bytes(lossless_jpeg(rgb, [(1, 1)] * 3, 4, 0, restart=46))
    for name, colour, depth, extra in (
            ("small_c2d8_srgb.png", 2, 8, _chunk(b"sRGB", b"\0")),
            ("small_c2d16_gama.png", 2, 16, _chunk(b"gAMA", struct.pack(">I", 45455))),
            ("small_c6d16_gama_sbit.png", 6, 16, _chunk(b"sBIT", bytes([12, 12, 12, 16])) +
             _chunk(b"gAMA", struct.pack(">I", 70000)))):
        samples, _ = _png_case(rng, 13, 19, colour, depth)
        write_png_any(str(out / name), samples, depth, colour, extra=extra)
    tiff = b"MM\0*\0\0\0\x08\0\x01" + struct.pack(">HHIHH", 0x0112, 3, 1, 6, 0) + b"\0\0\0\0"
    write_png_any(str(out / "small_c0d16_exif6.png"), _texture(rng, (9, 14, 1), np.uint16), 16, 0,
                  extra=_chunk(b"eXIf", tiff))
    disp = _texture(rng, (15, 26))
    _cv2_jpeg(str(out / "disp_gray.jpg"), disp, cv2.IMWRITE_JPEG_QUALITY, 95)
    data = open(_cv2_jpeg(str(out / "disp_exif8.jpg"), disp, cv2.IMWRITE_JPEG_QUALITY, 90), "rb").read()
    tiff = b"II*\0\x08\0\0\0\x01\0" + struct.pack("<HHIHH", 0x0112, 3, 1, 8, 0) + b"\0\0\0\0"
    (out / "disp_exif8.jpg").write_bytes(data[:2] + segment(0xE1, b"Exif\0\0" + tiff) + data[2:])


def _digest(a) -> dict:
    a = np.asarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype), "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def _digests(folder: Path) -> dict:
    return {"files": {p.name: _digest(np.array(Image.open(p))) for p in sorted(folder.iterdir())
                      if p.suffix in (".png", ".jpg", ".ppm")}}


def _opencv_digests(folder: Path) -> dict:
    """The JAX package's `read_disp_kitti` (OpenCV's) of every file OpenCV
    reads."""
    return {"files": {p.name: _digest(jfu.read_disp_kitti(str(p))[0]) for p in sorted(folder.iterdir())
                      if p.suffix in (".png", ".jpg", ".ppm") and cv2.imread(str(p), cv2.IMREAD_ANYDEPTH) is not None}}


def test_format_fixture_digests_are_pils():
    """The recorded digests are PIL's decode of the committed files, the
    folder holds every form the card's host checks and stays under its cap,
    and the port decodes every file to its digest."""
    record = json.loads((FIXTURES / "digests.json").read_text())
    assert record["files"] == _digests(FIXTURES)["files"]
    forms = {"stereo.left.progressive.jpg", "small_cmyk.jpg", "small_411.jpg", "small_progressive_gray.jpg",
             "small_adam7_rgb.png", "small_c0d1.png", "small_c0d2.png", "small_c0d4.png", "small_c2d16.png",
             "small_c4d16.png", "small_c6d16.png"} | {f"small_P{i}.ppm" for i in range(1, 7)} | NEW_FORMS
    assert forms <= set(record["files"])
    assert record["files"]["stereo.left.progressive.jpg"]["shape"] == [540, 960, 3]
    assert open(FIXTURES / "stereo.left.progressive.jpg", "rb").read().count(b"\xff\xc2") == 1
    assert sum(os.path.getsize(p) for p in FIXTURES.iterdir()) <= FIXTURE_CAP
    for name, want in record["files"].items():
        assert _digest(tfu.read_gen(str(FIXTURES / name))) == want, name
        if name.endswith(".png"):
            p = str(FIXTURES / name)
            _same(tpng.decode_png(p, "c").samples, tpng.decode_png(p, "numpy").samples, name)


def test_format_fixture_opencv_digests():
    """The recorded read_disp_kitti digests are OpenCV's decode of the
    committed files (every file cv2 reads: the gamma and EXIF PNGs, the
    JPEG and Netpbm maps among them), and the port's read_disp_kitti gives
    each."""
    record = json.loads((FIXTURES / OPENCV_DIGESTS).read_text())
    assert record["files"] == _opencv_digests(FIXTURES)["files"]
    assert {"small_c2d8_srgb.png", "small_c2d16_gama.png", "small_c0d16_exif6.png", "disp_gray.jpg",
            "disp_exif8.jpg", "small_P5.ppm", "small_P6.ppm", "small_arith_sof9.jpg"} <= set(record["files"])
    assert record["files"]["small_c0d16_exif6.png"]["shape"] == [14, 9]
    for name, want in record["files"].items():
        assert _digest(tfu.read_disp_kitti(str(FIXTURES / name))[0]) == want, name
