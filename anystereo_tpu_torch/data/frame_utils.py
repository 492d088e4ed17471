"""Image and disparity file readers and writers (twin of
`anystereo_tpu/data/frame_utils.py`): PFM, .flo, KITTI's 16-bit PNG
(disparity x 256, 0 = invalid), Sintel's RGB-packed disparity with its
occlusion mask, FallingThings' depth turned into disparity by the camera's
focal length, TartanAir's depth (.npy, disparity = 80 / depth), and
Middlebury's PFM with its non-occluded mask.

PNG and PPM are decoded by the port itself (`data/png.py`, `read_ppm`), with
no OpenCV or PIL.  JPEG (FallingThings) is read through PIL where PIL is
installed; without it `read_gen` raises an `ImportError` naming the file.
"""

from __future__ import annotations

import json
import os
import re
from os.path import basename, splitext
from typing import Optional, Tuple, Union

import numpy as np

from anystereo_tpu_torch.data.png import read_png


def read_pfm(path: str) -> np.ndarray:
    """Portable float map; returns [H, W] or [H, W, 3] float32 (row order
    flipped to top-down)."""
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


def read_ppm(path: str) -> np.ndarray:
    """Binary PPM (P6, [H, W, 3]) or PGM (P5, [H, W]); uint8, or uint16
    for a maximum value above 255."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:  # magic, width, height, maxval; '#' starts a comment
        m = re.compile(rb"\s*(?:#[^\n]*\n\s*)*(\S+)").match(data, pos)
        if m is None:
            raise ValueError(f"{path}: malformed PPM header")
        fields.append(m.group(1))
        pos = m.end()
    magic, w, h, maxval = fields[0], int(fields[1]), int(fields[2]), int(fields[3])
    if magic not in (b"P5", b"P6"):
        raise NotImplementedError(f"{path}: PPM type {magic!r} is not supported (P5 and P6 are)")
    ch = 3 if magic == b"P6" else 1
    dtype = np.dtype(">u2" if maxval > 255 else np.uint8)
    img = np.frombuffer(data, dtype, count=h * w * ch, offset=pos + 1)
    img = img.astype(np.uint16 if maxval > 255 else np.uint8).reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def _read_jpeg(path: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: reading JPEG needs PIL, which is not installed") from e
    return np.array(Image.open(path))


def _imread(path: str) -> np.ndarray:
    ext = splitext(path)[1].lower()
    if ext == ".png":
        return read_png(path)
    if ext == ".ppm":
        return read_ppm(path)
    if ext in (".jpg", ".jpeg"):
        return _read_jpeg(path)
    raise ValueError(f"{path}: not an image format the readers know")


def read_disp_kitti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """16-bit PNG / 256; zero = invalid."""
    disp = read_png(path).astype(np.float32) / 256.0
    return disp, disp > 0.0


def read_disp_sintel(path: str) -> Tuple[np.ndarray, np.ndarray]:
    a = _imread(path).astype(np.float32)
    disp = a[..., 0] * 4 + a[..., 1] / 2**6 + a[..., 2] / 2**14
    mask = _imread(path.replace("disparities", "occlusions"))
    return disp, (mask == 0) & (disp > 0)


def read_disp_falling_things(path: str) -> Tuple[np.ndarray, np.ndarray]:
    a = _imread(path).astype(np.float32)
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
        nocc = _imread(path.replace("disp0GT.pfm", "mask0nocc.png")) == 255
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
        return _imread(path)
    if ext in (".bin", ".raw"):
        return np.load(path)
    if ext == ".flo":
        return read_flo(path).astype(np.float32)
    if ext == ".pfm":
        flow = read_pfm(path)
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    return []
