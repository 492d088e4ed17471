"""The last image forms the JAX package reads, held to it bit for bit:
OpenCV's `cv2.imread(path, cv2.IMREAD_ANYDEPTH)` behind `read_disp_kitti`
(EXIF orientation of a PNG or JPEG, libjpeg's gray of a JPEG, OpenCV's
Netpbm gray, libpng's gray through its gamma tables) and PIL's
`np.array(Image.open(path))` behind `read_gen` for the JPEGs libjpeg-turbo
decodes and PIL and OpenCV do not write: progressive files whose scans
stop early (libjpeg smooths their blocks), arithmetic-coded files (SOF9,
SOF10) and lossless files (SOF3).  Those are written here by
`tests/jpeg_writers.py` from seeded coefficients or samples; PIL is the
decoder that checks both that writer and the port.

Tolerances: none.  Every array equals its reference in shape, dtype and
bytes.
"""

import io
import struct

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
from PIL import Image  # noqa: E402

from anystereo_tpu.data import frame_utils as jfu  # noqa: E402
from anystereo_tpu_torch.data import frame_utils as tfu  # noqa: E402
from anystereo_tpu_torch.data import png as tpng  # noqa: E402
from anystereo_tpu_torch.data.jpeg import decode_jpeg  # noqa: E402
from jpeg_writers import PROGRESSION, arith_jpeg, lossless_jpeg, random_blocks, segment  # noqa: E402
from test_torch_formats import (SAMPLING, _chunk, _cv2_jpeg, _markers, _pil_jpeg, _png_case, _same,  # noqa: E402
                                _texture, _write_ppm, write_png_any)


def _kitti_same(path):
    """The port's read_disp_kitti against the JAX package's (OpenCV's)."""
    got, want = tfu.read_disp_kitti(str(path)), jfu.read_disp_kitti(str(path))
    _same(got[0], want[0], str(path))
    _same(got[1], want[1], str(path))


def _pil_same(data, name="f.jpg"):
    """PIL reads `data`, and the port's decode of it is PIL's array."""
    want = np.array(Image.open(io.BytesIO(data)))
    _same(decode_jpeg(data, name), want, name)
    return want


# --------------------------------------------------------------- EXIF

def _tiff(order, entries, ifd=8, mark=42):
    """TIFF data: byte order `order` ("MM", "II" or anything), its 42, the
    first IFD at `ifd` with `entries` ((tag, type, count, 4 value bytes))."""
    e = "<" if order == "II" else ">"
    head = order.encode() + struct.pack(e + "HI", mark, ifd) + b"\0" * (ifd - 8)
    body = struct.pack(e + "H", len(entries)) + b"".join(struct.pack(e + "HHI", t, k, n) + v
                                                       for t, k, n, v in entries)
    return head + body + b"\0\0\0\0"


def _orient(order, value):
    e = "<" if order == "II" else ">"
    return (0x0112, 3, 1, struct.pack(e + "H", value) + b"\0\0")


def _png_with_exif(path, tiff, after_idat=False, crc_ok=True, rng=None):
    rng = rng or np.random.RandomState(0)
    samples = _texture(rng, (6, 10, 1), np.uint16)
    write_png_any(str(path), samples, 16, 0)
    data = open(path, "rb").read()
    chunk = bytearray(_chunk(b"eXIf", tiff))
    if not crc_ok:
        chunk[-1] ^= 1
    at = data.index(b"IEND") - 4 if after_idat else data.index(b"IDAT") - 4
    open(path, "wb").write(data[:at] + bytes(chunk) + data[at:])
    return path


def _jpeg_with_app1(path, bodies, where="soi"):
    data = open(_cv2_jpeg(str(path), _texture(np.random.RandomState(1), (6, 10)), cv2.IMWRITE_JPEG_QUALITY,
                          95), "rb").read()
    segs = b"".join(segment(0xE1, b) for b in bodies)
    at = {"soi": 2, "before_sos": data.index(b"\xff\xda")}[where]
    open(path, "wb").write(data[:at] + segs + data[at:])
    return path


@pytest.mark.parametrize("order", ["MM", "II"])
@pytest.mark.parametrize("container", ["png", "jpeg"])
def test_exif_orientation(tmp_path, container, order):
    """Orientations 0-9 in a PNG eXIf chunk and a JPEG APP1 segment, both
    byte orders: OpenCV turns the KITTI map by 2-8 (1, 0 and 9 leave it),
    PIL's read_gen never turns it."""
    for value in range(10):
        tiff = _tiff(order, [(0x010F, 2, 4, b"cam\0"), _orient(order, value)])
        p = tmp_path / f"o{value}.{container}"
        if container == "png":
            _png_with_exif(p, tiff)
        else:
            _jpeg_with_app1(p, [b"Exif\0\0" + tiff])
        _kitti_same(p)
        _same(tfu.read_gen(str(p)), jfu.read_gen(str(p)), str(p))
        plain = np.array(Image.open(p))
        assert jfu.read_disp_kitti(str(p))[0].shape == (plain.shape[::-1] if value in (5, 6, 7, 8) else plain.shape)


EXIF_CASES = {
    "png after IDAT": ("png", dict(after_idat=True), _tiff("MM", [_orient("MM", 6)])),
    "png bad CRC": ("png", dict(crc_ok=False), _tiff("MM", [_orient("MM", 6)])),
    "png XX order": ("png", {}, _tiff("XX", [_orient("MM", 6)])),
    "png mark 43": ("png", {}, _tiff("MM", [_orient("MM", 6)], mark=43)),
    "png too short": ("png", {}, b"MM\0"),
    "jpeg XX order": ("jpeg", {}, _tiff("XX", [_orient("MM", 6)])),
    "jpeg MI order": ("jpeg", {}, _tiff("MI", [_orient("MM", 5)])),
    "jpeg mark 43": ("jpeg", {}, _tiff("MM", [_orient("MM", 6)], mark=43)),
    "jpeg IFD past the end": ("jpeg", {}, _tiff("MM", [_orient("MM", 6)])[:4] + b"\0\0\0\x80"),
    "jpeg entries past the end": ("jpeg", {}, _tiff("MM", [_orient("MM", 7)])[:8] + b"\0\x05" +
                                  _tiff("MM", [_orient("MM", 7)])[10:-4]),
    "jpeg value cut": ("jpeg", {}, _tiff("MM", [_orient("MM", 6)])[:-7]),
    "jpeg LONG type": ("jpeg", {}, _tiff("MM", [(0x0112, 4, 1, struct.pack(">I", 6))])),
    "jpeg value 262": ("jpeg", {}, _tiff("MM", [_orient("MM", 262)])),
    "jpeg bad string first": ("jpeg", {}, _tiff("MM", [(0x010F, 2, 20, struct.pack(">I", 500)),
                                                       _orient("MM", 6)])),
    "jpeg bad rational first": ("jpeg", {}, _tiff("MM", [(0x011A, 5, 1, struct.pack(">I", 500)),
                                                         _orient("MM", 6)])),
    "jpeg unknown tag first": ("jpeg", {}, _tiff("MM", [(0x9999, 2, 20, struct.pack(">I", 500)),
                                                        _orient("MM", 8)])),
    "jpeg twice": ("jpeg", {}, (_tiff("MM", [_orient("MM", 6)]), _tiff("MM", [_orient("MM", 3)]))),
    "jpeg failed then found": ("jpeg", {}, (b"MM", _tiff("II", [_orient("II", 3)]))),
    "jpeg none then found": ("jpeg", {}, (_tiff("MM", [(0x0100, 3, 1, b"\0\x05\0\0")]),
                                          _tiff("MM", [_orient("MM", 4)]))),
    "jpeg XMP before": ("jpeg", {"xmp": True}, _tiff("MM", [_orient("MM", 2)])),
    "jpeg other prefix": ("jpeg", {"prefix": b"Exif\0\1"}, _tiff("MM", [_orient("MM", 6)])),
    "jpeg before SOS": ("jpeg", {"where": "before_sos"}, _tiff("MM", [_orient("MM", 7)])),
}


@pytest.mark.parametrize("case", list(EXIF_CASES))
def test_exif_as_opencv_reads_it(tmp_path, case):
    """Where OpenCV finds the orientation and where it does not: an eXIf
    chunk after the image data counts, one whose CRC fails or whose header
    libpng finds invalid does not; a malformed IFD stops the walk, keeping
    what it found; the first orientation of all a JPEG's Exif segments
    stands."""
    container, kw, tiff = EXIF_CASES[case]
    p = tmp_path / f"x.{container}"
    if container == "png":
        _png_with_exif(p, tiff, **kw)
    else:
        tiffs = tiff if isinstance(tiff, tuple) else (tiff,)
        bodies = [kw.get("prefix", b"Exif\0\0") + t for t in tiffs]
        if kw.get("xmp"):
            bodies.insert(0, b"http://ns.adobe.com/xap/1.0/\0<x/>")
        _jpeg_with_app1(p, bodies, kw.get("where", "soi"))
    _kitti_same(p)


# -------------------------------------------------- OpenCV's gray decode

JPEG_MAPS = ["gray", "444", "422", "420", "411", "440", "progressive 420", "progressive gray",
             "Adobe RGB", "CMYK", "YCCK", "arithmetic 420", "lossless gray"]


@pytest.mark.parametrize("kind", JPEG_MAPS)
def test_opencv_gray_of_jpeg_maps(tmp_path, kind):
    """A disparity map saved as a JPEG under a PNG name (OpenCV reads by
    content): libjpeg's gray (the Y plane; Adobe RGB through rgb_gray) and
    OpenCV's CMYK to gray."""
    rng = np.random.RandomState(len(kind))
    for h, w in [(1, 1), (9, 13), (21, 35)]:
        p = str(tmp_path / f"{h}x{w}_10.png")
        if kind in ("gray", "444", "422", "420", "411", "440"):
            arr = _texture(rng, (h, w) if kind == "gray" else (h, w, 3))
            params = [] if kind == "gray" else [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[kind]]
            _cv2_jpeg(p, arr, cv2.IMWRITE_JPEG_QUALITY, 85, *params)
        elif kind.startswith("progressive"):
            arr = _texture(rng, (h, w) if kind.endswith("gray") else (h, w, 3))
            _pil_jpeg(p, arr, quality=80, progressive=True)
        elif kind == "Adobe RGB":
            Image.fromarray(_texture(rng, (h, w, 3))).save(p, "JPEG", keep_rgb=True, quality=90)
            assert b"Adobe" in open(p, "rb").read()
        elif kind in ("CMYK", "YCCK"):
            _pil_jpeg(p, _texture(rng, (h, w, 4)), quality=85)
            data = bytearray(open(p, "rb").read())
            data[data.index(b"Adobe") + 11] = 2 if kind == "YCCK" else 0
            open(p, "wb").write(bytes(data))
        elif kind == "arithmetic 420":
            mx, my = -(-w // 16), -(-h // 16)
            blocks = [random_blocks(rng, 2 * my, 2 * mx), random_blocks(rng, my, mx), random_blocks(rng, my, mx)]
            open(p, "wb").write(arith_jpeg(h, w, [(2, 2), (1, 1), (1, 1)], blocks, restart=2))
        else:
            open(p, "wb").write(lossless_jpeg([rng.randint(0, 256, (h, w)).astype(np.uint8)], [(1, 1)], 4,
                                              restart=w))
        _kitti_same(p)


NETPBM = [("P1", 1), ("P4", 1)] + [(m, v) for m in ("P2", "P3", "P5", "P6") for v in (1, 15, 255, 256, 1000, 65535)]


@pytest.mark.parametrize("magic,maxval", NETPBM, ids=[f"{m}-{v}" for m, v in NETPBM])
def test_opencv_gray_of_netpbm_maps(tmp_path, magic, maxval):
    """P1-P6 at maxvals 1 to 65535 as OpenCV's PxM decoder reads them gray
    (plain values scaled to 0-255 below 256, raw ones not; 16 bits whole
    above 255; pixmaps through its BGR-to-gray)."""
    rng = np.random.RandomState(maxval + int(magic[1]))
    bands = 3 if magic in ("P3", "P6") else 1
    for h, w in [(1, 1), (5, 3), (13, 17)]:
        values = rng.randint(0, maxval + 1, (h, w, bands) if bands == 3 else (h, w))
        _kitti_same(_write_ppm(str(tmp_path / f"{h}x{w}.ppm"), magic, values, maxval))


NETPBM_FORMS = {
    "tabs": b"P2\t3\t1\t9 0 9 4\n",
    "packed bitmap": b"P1 3 2 010110",
    "raw above maxval": b"P5 2 1 7\n" + bytes([3, 200]),
    "wide raw above maxval": b"P6 1 1 300\n" + bytes([1, 200, 0, 2, 255, 255]),
    "plain above maxval": b"P3 1 1 10 11 3 12\n",
    "bitmap digit 2": b"P1 2 2 0 1 2 0",
    "comment in the body": b"P2 2 2 9\n1 # c\n2 3\n4\n",
    "CR LF": b"P5\r\n2 1\r\n255\r\n" + bytes([1, 2]),
    "'#' ends maxval": b"P5 2 1 255#x\n" + bytes([7, 8, 9, 10]),
    "comment inside a token": b"P5\n1#c\n2 1\n255\n" + bytes(range(12)),
    "last value unended": b"P2 2 2 9\n1 2\n3 4",
    "letter in the body": b"P2 2 1 9 a 1\n",
    "width 0": b"P5 0 1 255\n",
    "maxval 70000": b"P2 1 1 70000 5\n",
    "raw data short": b"P4 9 2\n" + bytes([255, 0, 1]),
}


@pytest.mark.parametrize("form", list(NETPBM_FORMS))
def test_opencv_netpbm_header_forms(tmp_path, form):
    """OpenCV's own header and number parse (not PIL's): a comment or
    whitespace between numbers, any other byte refused, a number ended by
    the byte after it (which a last value must have), plain values above
    maxval clipped, raw ones kept.  Where cv2 reads nothing (None, on which
    the JAX package's reader fails) the port raises ValueError."""
    p = tmp_path / "h.ppm"
    p.write_bytes(NETPBM_FORMS[form])
    if cv2.imread(str(p), cv2.IMREAD_ANYDEPTH) is None:
        with pytest.raises(AttributeError):
            jfu.read_disp_kitti(str(p))
        with pytest.raises(ValueError, match="h.ppm: "):
            tfu.read_disp_kitti(str(p))
    else:
        _kitti_same(p)


GAMMA_CHUNKS = {
    "sRGB": _chunk(b"sRGB", b"\0"),
    "gAMA 45455": _chunk(b"gAMA", struct.pack(">I", 45455)),
    "gAMA 100000": _chunk(b"gAMA", struct.pack(">I", 100000)),
    "gAMA 70000": _chunk(b"gAMA", struct.pack(">I", 70000)),
    "gAMA 220000": _chunk(b"gAMA", struct.pack(">I", 220000)),
    "gAMA 1": _chunk(b"gAMA", struct.pack(">I", 1)),
    "gAMA 45455 cHRM": _chunk(b"gAMA", struct.pack(">I", 45455)) + _chunk(b"cHRM", struct.pack(
        ">8I", 31270, 32900, 64000, 33000, 30000, 60000, 15000, 6000)),
    "sRGB over gAMA": _chunk(b"gAMA", struct.pack(">I", 100000)) + _chunk(b"sRGB", b"\0"),
    "first gAMA": _chunk(b"gAMA", struct.pack(">I", 45455)) + _chunk(b"gAMA", struct.pack(">I", 100000)),
    "sRGB intent 4": _chunk(b"sRGB", b"\4"),
    "gAMA bad CRC": _chunk(b"gAMA", struct.pack(">I", 45455))[:-1] + b"\0",
    "sBIT 12 gAMA": _chunk(b"sBIT", bytes([12, 10, 11])) + _chunk(b"gAMA", struct.pack(">I", 45455)),
    "sBIT 5 gAMA": _chunk(b"sBIT", bytes([5, 3, 4])) + _chunk(b"gAMA", struct.pack(">I", 60000)),
}
GAMMA_TYPES = [(2, 8), (2, 16), (3, 4), (3, 8), (6, 8), (6, 16)]


@pytest.mark.parametrize("colour,depth", GAMMA_TYPES, ids=[f"c{c}d{d}" for c, d in GAMMA_TYPES])
def test_opencv_gamma_gray(tmp_path, colour, depth):
    """libpng turns colour gray for OpenCV in linear light where a gAMA (or
    sRGB) chunk says the file's gamma is not 1: gamma_to_1, the 0.299/0.587
    sum, gamma_from_1, at 8 and 16 bits (16-bit tables shortened by sBIT);
    a palette file's colour is turned without them.  The port's
    read_png(mode="opencv") and read_disp_kitti against cv2's, each chunk
    form; a gAMA after the PLTE or the image data counts for nothing."""
    rng = np.random.RandomState(colour * 100 + depth)
    for name, extra in GAMMA_CHUNKS.items():
        samples, palette = _png_case(rng, 11, 15, colour, depth)
        samples[0, :6] = samples[0, :6, :1]  # gray pixels, which libpng keeps as they are
        p = write_png_any(str(tmp_path / "g.png"), samples, depth, colour, 0, palette, extra=extra)
        _same(tpng.read_png(p, mode="opencv"), cv2.imread(p, cv2.IMREAD_ANYDEPTH), name)
        _kitti_same(p)
    samples, _ = _png_case(rng, 11, 15, 2, 8)
    p = write_png_any(str(tmp_path / "late.png"), samples, 8, 2)
    data = open(p, "rb").read()
    at = data.index(b"IEND") - 4
    open(p, "wb").write(data[:at] + GAMMA_CHUNKS["gAMA 45455"] + data[at:])
    plain = write_png_any(str(tmp_path / "plain.png"), samples, 8, 2)
    _same(tpng.read_png(p, mode="opencv"), cv2.imread(plain, cv2.IMREAD_ANYDEPTH))
    _kitti_same(p)


# ------------------------------------------------------ block smoothing

def _cuts(data):
    """The file cut after each of its scans but the last, an EOI appended."""
    scans = [pos for m, pos in _markers(data) if m == 0xDA]
    return [data[:pos] + b"\xff\xd9" for pos in scans[1:]]


@pytest.mark.parametrize("kind", ["pil gray", "pil 420", "pil 444", "pil 422", "opencv 420 restarts",
                                  "opencv gray restarts"])
def test_smoothed_progressive_files(tmp_path, kind):
    """A progressive file cut at every scan boundary (as a download that
    stopped): libjpeg smooths the blocks whose AC 1-9 are unfinished, and
    interpolates the DC while no AC scan has come.  The port gives PIL's
    array for each cut, at sizes with partial blocks and iMCU rows, and
    OpenCV's gray through read_disp_kitti."""
    rng = np.random.RandomState(len(kind))
    for h, w in [(9, 9), (17, 33), (40, 24)]:
        p = str(tmp_path / "c.jpg")
        if kind.startswith("pil"):
            sub = kind.split()[1]
            arr = _texture(rng, (h, w) if sub == "gray" else (h, w, 3))
            kw = {} if sub == "gray" else {"subsampling": {"444": 0, "422": 1, "420": 2}[sub]}
            _pil_jpeg(p, arr, quality=90, progressive=True, **kw)
        else:
            gray = "gray" in kind
            arr = _texture(rng, (h, w) if gray else (h, w, 3))
            params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 2]
            if not gray:
                params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"]]
            _cv2_jpeg(p, arr, *params)
        cuts = _cuts(open(p, "rb").read())
        assert len(cuts) >= 5
        for k, data in enumerate(cuts):
            want = _pil_same(data, f"cut{k}.jpg")
            assert k < len(cuts) - 1 or want.shape[:2] == (h, w)
        open(p, "wb").write(cuts[0])
        _kitti_same(p)


# ------------------------------------------------------------ arithmetic

def _blocks(rng, h, w, sampling):
    if len(sampling) == 1:
        return [random_blocks(rng, -(-h // 8), -(-w // 8))]
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    return [random_blocks(rng, my * v, mx * hh) for hh, v in sampling]


ARITH_SAMPLINGS = {"gray": [(1, 1)], "420": [(2, 2), (1, 1), (1, 1)], "444": [(1, 1)] * 3,
                   "422": [(2, 1), (1, 1), (1, 1)], "411": [(4, 1), (1, 1), (1, 1)], "4 components": [(1, 1)] * 4}


@pytest.mark.parametrize("progressive", [False, True], ids=["SOF9", "SOF10"])
@pytest.mark.parametrize("sampling", list(ARITH_SAMPLINGS))
def test_arithmetic_coded(sampling, progressive):
    """Arithmetic-coded files from the test writer: sequential (with
    restarts: the first component in a scan of its own, the rest in a
    second) and progressive (DC and AC first and refinement scans), with and
    without restarts, with the default conditioning and a DAC segment that
    changes it (L, U of the DC tables, K of the AC ones), tables 0-7.  PIL
    reads each, the port gives its array, and OpenCV's gray matches."""
    rng = np.random.RandomState(len(sampling) + 10 * progressive)
    dacs = (None, {(0, 0): 0x52, (0, 1): 0x31, (0, 2): 0x10, (0, 3): 0xF0, (1, 4): 10, (1, 5): 2, (1, 6): 1,
                   (1, 7): 63})
    split = [((0,), 0, 63, 0, 0), ((1, 2, 3), 0, 63, 0, 0)]
    for h, w in [(1, 1), (17, 33)]:
        for restart in (0, 3):
            for dac in dacs:
                script = PROGRESSION if progressive else split if restart and len(ARITH_SAMPLINGS[sampling]) > 1 else None
                data = arith_jpeg(h, w, ARITH_SAMPLINGS[sampling], _blocks(rng, h, w, ARITH_SAMPLINGS[sampling]),
                                  progressive=progressive, restart=restart, dac=dac, script=script)
                assert data[data.index(b"\xff\xc9" if not progressive else b"\xff\xca") + 1] in (0xC9, 0xCA)
                _pil_same(data)
                cv = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_ANYDEPTH)
                _same(decode_jpeg(data, mode="opencv"), cv)


def test_arithmetic_smoothed():
    """An arithmetic progressive file cut after each scan is smoothed as a
    Huffman one is."""
    rng = np.random.RandomState(8)
    data = arith_jpeg(24, 40, ARITH_SAMPLINGS["420"], _blocks(rng, 24, 40, ARITH_SAMPLINGS["420"]),
                      progressive=True, script=PROGRESSION)
    for cut in _cuts(data):
        _pil_same(cut)


# -------------------------------------------------------------- lossless

@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless(psv):
    """Lossless files (SOF3) by each predictor, point transforms 0 and 3,
    restart intervals of one and two rows: gray, RGB (no marker, and
    Adobe's transform 0) at 1x1 and 2x2 sampling (libjpeg upsamples
    those by repeating samples), components in one scan and in two."""
    rng = np.random.RandomState(psv)
    adobe0 = segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0))
    for h, w in [(1, 1), (7, 10)]:
        for pt in (0, 3):
            for rows in (0, 1, 2):
                gray = rng.randint(0, 256, (h, w)).astype(np.uint8)
                want = _pil_same(lossless_jpeg([gray], [(1, 1)], psv, pt, restart=rows * w))
                _same(want, gray >> pt << pt)
                rgb = [rng.randint(0, 256, (h, w)).astype(np.uint8) for _ in range(3)]
                _pil_same(lossless_jpeg(rgb, [(1, 1)] * 3, psv, pt, restart=rows * w, markers=adobe0 if rows else b""))
                _pil_same(lossless_jpeg(rgb, [(1, 1)] * 3, psv, pt, restart=rows * w, scans=[(0,), (1, 2)]))
                sub = [rng.randint(0, 256, (2 * -(-h // 2), 2 * -(-w // 2))).astype(np.uint8),
                       rng.randint(0, 256, (-(-h // 2), -(-w // 2))).astype(np.uint8),
                       rng.randint(0, 256, (-(-h // 2), -(-w // 2))).astype(np.uint8)]
                sub[0] = sub[0][:h, :w]
                _pil_same(lossless_jpeg(sub, [(2, 2), (1, 1), (1, 1)], psv, pt, restart=rows * -(-w // 2),
                                        ids=[82, 71, 66]))


def _marker_rewritten(data, marker, to):
    data = bytearray(data)
    data[data.index(bytes([0xFF, marker])) + 1] = to
    return bytes(data)


LOSSLESS_REFUSED = {
    "SOF11 arithmetic lossless": ("arithmetic-coded lossless JPEG \\(SOF11\\)"),
    "12-bit lossless": ("12-bit JPEG samples"),
    "16-bit lossless": ("16-bit JPEG samples"),
    "YCbCr lossless (JFIF)": ("lossless JPEG in YCbCr"),
    "YCbCr lossless (Adobe 1)": ("lossless JPEG in YCbCr"),
}


@pytest.mark.parametrize("case", list(LOSSLESS_REFUSED))
def test_lossless_refusals_pil_shares(tmp_path, case):
    """What libjpeg-turbo under PIL does not decode, the port refuses with
    NotImplementedError naming the file and the form: arithmetic-coded
    lossless files, precisions other than 8 (PIL reads 8 only), and a
    lossless YCbCr file (libjpeg converts no colour in lossless mode)."""
    rng = np.random.RandomState(2)
    gray = rng.randint(0, 256, (5, 6)).astype(np.uint8)
    rgb = [rng.randint(0, 256, (5, 6)).astype(np.uint8) for _ in range(3)]
    data = {
        "SOF11 arithmetic lossless": lambda: _marker_rewritten(lossless_jpeg([gray], [(1, 1)], 1), 0xC3, 0xCB),
        "12-bit lossless": lambda: lossless_jpeg([gray], [(1, 1)], 1, precision=12),
        "16-bit lossless": lambda: lossless_jpeg([gray], [(1, 1)], 1, precision=16),
        "YCbCr lossless (JFIF)": lambda: lossless_jpeg(rgb, [(1, 1)] * 3, 1, markers=segment(
            0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")),
        "YCbCr lossless (Adobe 1)": lambda: lossless_jpeg(rgb, [(1, 1)] * 3, 1, markers=segment(
            0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 1))),
    }[case]()
    p = tmp_path / "r.jpg"
    p.write_bytes(data)
    with pytest.raises((OSError, SyntaxError)):
        jfu.read_gen(str(p))
    with pytest.raises(NotImplementedError, match=f"r.jpg: .*{LOSSLESS_REFUSED[case]}"):
        tfu.read_gen(str(p))


def test_lossless_rgb_has_no_opencv_gray(tmp_path):
    """OpenCV asks libjpeg for gray, which a lossless RGB file cannot give:
    cv2 returns None (the JAX package's reader then fails), the port
    refuses by name; a lossless gray map reads."""
    rng = np.random.RandomState(3)
    p = tmp_path / "000000_10.png"
    p.write_bytes(lossless_jpeg([rng.randint(0, 256, (5, 6)).astype(np.uint8) for _ in range(3)], [(1, 1)] * 3, 2))
    assert cv2.imread(str(p), cv2.IMREAD_ANYDEPTH) is None
    with pytest.raises(NotImplementedError, match="000000_10.png: lossless JPEG in RGB"):
        tfu.read_disp_kitti(str(p))
    p.write_bytes(lossless_jpeg([rng.randint(0, 256, (5, 6)).astype(np.uint8)], [(1, 1)], 2))
    _kitti_same(p)
