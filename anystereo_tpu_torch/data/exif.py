"""EXIF orientation as `cv2.imread` applies it.

OpenCV rotates what it reads by the EXIF Orientation tag unless it is given
`IMREAD_IGNORE_ORIENTATION` (the JAX package's KITTI reader,
`cv2.imread(path, cv2.IMREAD_ANYDEPTH)`, does not give it); PIL's
`np.array(Image.open(path))` never rotates.  This module finds the tag as
OpenCV finds it and applies it as OpenCV's `ExifTransform` does:

- a PNG: the first `eXIf` chunk (before or after the image data) whose CRC
  holds, at least 4 bytes long and starting "MM\\0*" or "II*\\0" (libpng
  drops any other, and every later `eXIf`);
- a JPEG: every APP1 segment before the first SOS that starts "Exif\\0\\0"
  and holds more than those 6 bytes, in order; the first Orientation any of
  them gives stands;
- the TIFF data, as OpenCV's `ExifReader` walks it: the byte order from the
  first two bytes ("II" little-endian, anything else big-endian), 42 next,
  then the first IFD's entries in order; an entry's value is the 16-bit
  number at its byte 8, whatever its type and count says; a read past the
  end stops the walk, keeping what it found, and so does a string or
  rational entry whose data lies past the end (OpenCV reads those too);
- orientations 2-8 flip or transpose the image; 1 and any other value leave
  it as it is.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional

import numpy as np

ORIENTATION = 0x0112
# entries OpenCV's ExifReader reads the data of: strings (description,
# make, model, software, date, copyright) and rationals with their counts
# (resolutions, white point, primaries, YCbCr coefficients, reference black
# and white); resolution unit and YCbCr positioning are 16-bit like the
# orientation
_STRINGS = (0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298)
_RATIONALS = {0x011A: 1, 0x011B: 1, 0x013E: 2, 0x013F: 6, 0x0211: 3, 0x0214: 6}
_SHORTS = (0x0128, 0x0213)


class _End(Exception):
    """A read past the end of the TIFF data."""


def tiff_tags(tiff: bytes, found: Dict[int, int]) -> None:
    """Add the 16-bit entries of `tiff`'s first IFD to `found`, an entry
    already there standing (OpenCV's ExifReader::parseExif)."""
    n = len(tiff)
    little = n > 1 and tiff[0] == tiff[1] == ord("I")
    order = "<" if little else ">"

    def u16(o):
        if o + 1 >= n:
            raise _End
        return struct.unpack_from(order + "H", tiff, o)[0]

    def u32(o):
        if o + 3 >= n:
            raise _End
        return struct.unpack_from(order + "I", tiff, o)[0]

    try:
        if u16(2) != 42:
            return
        offset = u32(4)
        entries = u16(offset)
        offset += 2
        for _ in range(entries):
            tag = u16(offset)
            if tag == ORIENTATION or tag in _SHORTS:
                found.setdefault(tag, u16(offset + 8))
            elif tag in _STRINGS:
                size = u32(offset + 4)
                start = u32(offset + 8) if size > 4 else 8
                if start > n or start + size > n:
                    raise _End
            elif tag in _RATIONALS:
                at = u32(offset + 8)
                for k in range(_RATIONALS[tag]):
                    u32(at + 8 * k)
                    u32(at + 8 * k + 4)
            offset += 12
    except _End:
        pass


def png_orientation(data: bytes) -> Optional[int]:
    """The Orientation of a PNG file's EXIF as OpenCV reads it, or None."""
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if kind == b"IEND":
            break
        if (kind == b"eXIf" and len(crc) == 4 and len(body) == length
                and struct.unpack(">I", crc)[0] == zlib.crc32(kind + body) & 0xFFFFFFFF):
            if length >= 4 and body[:4] in (b"MM\0*", b"II*\0"):
                found: Dict[int, int] = {}
                tiff_tags(body, found)
                return found.get(ORIENTATION)
        pos += 12 + length
    return None


def jpeg_orientation(data: bytes) -> Optional[int]:
    """The Orientation of a JPEG file's EXIF as OpenCV reads it, or None."""
    found: Dict[int, int] = {}
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            break
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker in (0xDA, 0xD9):
            break
        length = struct.unpack_from(">H", data, pos + 2)[0]
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xE1 and len(body) > 6 and body[:6] == b"Exif\0\0":
            tiff_tags(body[6:], found)
        pos += 2 + length
    return found.get(ORIENTATION)


def apply(img: np.ndarray, orientation: Optional[int]) -> np.ndarray:
    """`img` ([H, W]) turned as OpenCV's ExifTransform turns it."""
    if orientation in (5, 6, 7, 8):
        img = img.T
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    return np.ascontiguousarray(np.flip(img, flip) if flip else img)
