"""Stereo augmentation on numpy, in loader workers (twin of
`anystereo_tpu/data/augment.py`).

Photometric: a colour jitter (brightness, contrast, saturation, hue, in a
random order, and an optional gamma), asymmetric with probability 0.2; an
eraser occluding the right image with probability 0.5 (1-2 rectangles of
50-100 px filled with its mean colour).  Spatial: a scale 2^U(min, max),
stretched with probability 0.8, h/v flips, a y-jitter of +-2 px, then a
crop; the multi-scale variant crops at the high-resolution size and
bicubic-downscales the images only to the low-resolution input size.
Sparse variants: a scatter-based rescale of the flow map and crops with
margins.

The JAX package calls OpenCV for the colour conversions and resizes, and
its native module for the sparse rescale; the port computes them itself, in
its own C: `rgb_to_gray`, `rgb_to_hsv` and `hsv_to_rgb` below
(`csrc/colour.c`), `utils/resize.resize` (`csrc/resize.c`) and
`data/native_io.scatter_resize_sparse` (`csrc/native_io.c`).  Each has its
plain numpy version, which gives the same arrays bit for bit
(`impl="numpy"`, or `utils/host_c.plain()` for a whole sample).  Every draw
from `rng` comes in the JAX module's order, so the same seed gives the same
crops, flips and queries.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from anystereo_tpu_torch.data import native_io
from anystereo_tpu_torch.utils import host_c
from anystereo_tpu_torch.utils.resize import resize

# ------------------------------------------------------------------ #
# colour conversions of uint8 RGB, as OpenCV computes them
# ------------------------------------------------------------------ #

_HSV_SHIFT = 12
_SDIV = np.array([0] + [round((255 << _HSV_SHIFT) / i) for i in range(1, 256)], np.int64)
_HDIV = np.array([0] + [round((180 << _HSV_SHIFT) / (6.0 * i)) for i in range(1, 256)], np.int64)
# (b, g, r) taken from tab = (v, v(1-s), v(1-s·f), v(1-s(1-f))) by hue sector
_SECTOR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _colour_fn(name: str):
    P, I64 = host_c.P, host_c.I64
    argtypes = {"rgb_to_gray": [P, P, I64], "rgb_to_hsv": [P, P, I64, P, P],
                "hsv_to_rgb": [P, P, I64, I64]}[name]
    return host_c.function("colour", name, argtypes)


def _u8_pixels(img: np.ndarray, what: str) -> np.ndarray:
    """`img` as the C-contiguous uint8 [..., 3] the C versions take."""
    if img.dtype != np.uint8 or img.ndim < 1 or img.shape[-1] != 3:
        raise ValueError(f"{what} takes uint8 [..., 3], got {img.dtype} {img.shape}")
    return np.ascontiguousarray(img)


def rgb_to_gray(img: np.ndarray, impl: Optional[str] = None) -> np.ndarray:
    """[..., 3] uint8 RGB -> [...] uint8: (9798 R + 19235 G + 3735 B +
    16384) >> 15, the fixed point of OpenCV 5's `COLOR_RGB2GRAY` (OpenCV 4
    rounds the same weights to 14 bits).  impl: "c" (the default,
    `csrc/colour.c`) or "numpy", the plain version."""
    if host_c.resolve(impl, "rgb_to_gray") == "c":
        src = _u8_pixels(img, "rgb_to_gray")
        out = np.empty(src.shape[:-1], np.uint8)
        _colour_fn("rgb_to_gray")(src.ctypes.data, out.ctypes.data, out.size)
        return out
    x = img.astype(np.int32)
    return ((9798 * x[..., 0] + 19235 * x[..., 1] + 3735 * x[..., 2] + 16384) >> 15).astype(np.uint8)


def rgb_to_hsv(img: np.ndarray, impl: Optional[str] = None) -> np.ndarray:
    """[..., 3] uint8 RGB -> uint8 HSV with hue in [0, 180), OpenCV's
    `COLOR_RGB2HSV` (12-bit fixed point, division tables).  impl: "c" (the
    default, `csrc/colour.c`, given these tables) or "numpy", the plain
    version."""
    if host_c.resolve(impl, "rgb_to_hsv") == "c":
        src = _u8_pixels(img, "rgb_to_hsv")
        out = np.empty(src.shape, np.uint8)
        _colour_fn("rgb_to_hsv")(src.ctypes.data, out.ctypes.data, src.size // 3, _SDIV.ctypes.data,
                                 _HDIV.ctypes.data)
        return out
    x = img.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


_HSV2RGB_BLOCK = 32  # pixels a step of OpenCV's vector code (4 x 8 float lanes)


def hsv_to_rgb(hsv: np.ndarray, impl: Optional[str] = None) -> np.ndarray:
    """uint8 [H, W, 3] HSV (hue in [0, 180)) -> uint8 RGB, as OpenCV's
    `COLOR_HSV2RGB` computes it: float32 arithmetic with 1 - s·x fused;
    each row in blocks of 32 pixels truncated to a level by its vector
    code, and the last W % 32 pixels of a row rounded by its scalar code.
    impl: "c" (the default, `csrc/colour.c`) or "numpy", the plain
    version."""
    if host_c.resolve(impl, "hsv_to_rgb") == "c":
        src = _u8_pixels(hsv, "hsv_to_rgb")
        if src.ndim < 2:
            raise ValueError(f"hsv_to_rgb takes uint8 [..., W, 3], got {src.shape}")
        out = np.empty(src.shape, np.uint8)
        w = src.shape[-2]
        _colour_fn("hsv_to_rgb")(src.ctypes.data, out.ctypes.data, src.size // max(3 * w, 1), w)
        return out
    h = hsv[..., 0].astype(np.float32) * np.float32(6.0 / 180.0)
    s = hsv[..., 1].astype(np.float32) * np.float32(1.0 / 255.0)
    v = hsv[..., 2].astype(np.float32) * np.float32(1.0 / 255.0)
    sector = np.floor(h)
    f = h - sector
    one = np.float32(1)
    s64 = s.astype(np.float64)
    # 1 - s·x with one rounding (a fused multiply-add): exact in float64
    tab = np.stack([v, v * (one - s), v * (1.0 - s64 * f).astype(np.float32),
                    v * (1.0 - s64 * (one - f)).astype(np.float32)], axis=-1)
    rgb = np.take_along_axis(tab, _SECTOR[sector.astype(np.int64) % 6], axis=-1)[..., ::-1]
    rgb = np.clip(rgb * np.float32(255), 0, 255)
    w = hsv.shape[-2]
    tail = np.arange(w) >= w - w % _HSV2RGB_BLOCK
    # the scalar code takes v itself where s == 0
    scalar = np.where((s == 0)[..., None], np.clip(v * np.float32(255), 0, 255)[..., None], rgb)
    return np.where(tail[:, None], np.rint(scalar), rgb).astype(np.uint8)


# ------------------------------------------------------------------ #
# photometric
# ------------------------------------------------------------------ #


def _blend(a: np.ndarray, b: np.ndarray, f: float) -> np.ndarray:
    return np.clip(f * a + (1.0 - f) * b, 0, 255)


def _adjust_brightness(img: np.ndarray, f: float) -> np.ndarray:
    return np.clip(img * f, 0, 255)


def _adjust_contrast(img: np.ndarray, f: float) -> np.ndarray:
    gray = rgb_to_gray(img.astype(np.uint8)).mean()
    return _blend(img, gray, f)


def _adjust_saturation(img: np.ndarray, f: float) -> np.ndarray:
    gray = rgb_to_gray(img.astype(np.uint8))[..., None]
    return _blend(img, gray, f)


def _adjust_hue(img: np.ndarray, shift: float) -> np.ndarray:
    """shift in [-0.5, 0.5] turns of the hue circle."""
    hsv = rgb_to_hsv(img.astype(np.uint8))
    h = hsv[..., 0].astype(np.int32)  # hue is [0, 180)
    hsv[..., 0] = ((h + int(round(shift * 180))) % 180).astype(hsv.dtype)
    return hsv_to_rgb(hsv).astype(np.float32)


def _adjust_gamma(img: np.ndarray, gamma: float, gain: float = 1.0) -> np.ndarray:
    return np.clip(255.0 * gain * (img / 255.0) ** gamma, 0, 255)


@dataclasses.dataclass
class ColorJitter:
    brightness: float = 0.4
    contrast: float = 0.4
    saturation: Tuple[float, float] = (0.0, 1.4)
    hue: float = 0.5 / 3.14
    gamma: Tuple[float, float, float, float] = (1, 1, 1, 1)  # (gmin,gmax,gainmin,gainmax)

    def __call__(self, img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        img = img.astype(np.float32)
        ops = []
        b = rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
        c = rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
        s = rng.uniform(*self.saturation)
        h = rng.uniform(-self.hue, self.hue)
        ops = [
            lambda x: _adjust_brightness(x, b),
            lambda x: _adjust_contrast(x, c),
            lambda x: _adjust_saturation(x, s),
            lambda x: _adjust_hue(x, h),
        ]
        for i in rng.permutation(4):  # torchvision applies in random order
            img = ops[i](img)
        gmin, gmax, gainmin, gainmax = self.gamma
        if (gmin, gmax) != (1, 1) or (gainmin, gainmax) != (1, 1):
            img = _adjust_gamma(
                img, rng.uniform(gmin, gmax), rng.uniform(gainmin, gainmax)
            )
        return img.astype(np.uint8)


# ------------------------------------------------------------------ #
# augmentors
# ------------------------------------------------------------------ #


@dataclasses.dataclass
class AugmentorConfig:
    crop_size: Tuple[int, int] = (320, 736)
    min_scale: float = -0.2
    max_scale: float = 0.4
    do_flip: Optional[str] = None  # 'h' | 'v' | 'hf' | None
    yjitter: bool = False
    saturation_range: Tuple[float, float] = (0.0, 1.4)
    gamma: Tuple[float, float, float, float] = (1, 1, 1, 1)
    # None → resolved by density: 1.0 dense (FlowAugmentor), 0.8 sparse
    # (SparseFlowAugmentor, augmentor.py:330 — 20% of sparse samples keep
    # native resolution with un-scattered GT)
    spatial_aug_prob: Optional[float] = None
    stretch_prob: float = 0.8
    max_stretch: float = 0.2
    h_flip_prob: float = 0.5
    v_flip_prob: float = 0.1
    asymmetric_color_prob: float = 0.2  # dense only; sparse always symmetric
    eraser_prob: float = 0.5


class StereoAugmentor:
    """Dense-GT augmentor (FlowAugmentor / FlowAugmentorWoCrop)."""

    def __init__(self, cfg: AugmentorConfig, sparse: bool = False):
        self.cfg = cfg
        self.sparse = sparse
        self.spatial_prob = (
            cfg.spatial_aug_prob
            if cfg.spatial_aug_prob is not None
            else (0.8 if sparse else 1.0)
        )
        sat = cfg.saturation_range
        if sparse:
            self.jitter = ColorJitter(0.3, 0.3, sat, 0.3 / 3.14, cfg.gamma)
        else:
            self.jitter = ColorJitter(0.4, 0.4, sat, 0.5 / 3.14, cfg.gamma)

    # -- photometric ------------------------------------------------ #

    def color_transform(self, img1, img2, rng):
        if not self.sparse and rng.rand() < self.cfg.asymmetric_color_prob:
            return self.jitter(img1, rng), self.jitter(img2, rng)
        stack = np.concatenate([img1, img2], axis=0)
        stack = self.jitter(stack, rng)
        return np.split(stack, 2, axis=0)

    def eraser_transform(self, img1, img2, rng, bounds=(50, 100)):
        ht, wd = img1.shape[:2]
        if rng.rand() < self.cfg.eraser_prob:
            img2 = img2.copy()
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            for _ in range(rng.randint(1, 3)):
                x0, y0 = rng.randint(0, wd), rng.randint(0, ht)
                dx, dy = rng.randint(*bounds), rng.randint(*bounds)
                img2[y0 : y0 + dy, x0 : x0 + dx] = mean_color
        return img1, img2

    # -- spatial ---------------------------------------------------- #

    def _sample_scales(self, ht, wd, crop, rng):
        pad = 1 if self.sparse else 8
        min_scale = max((crop[0] + pad) / ht, (crop[1] + pad) / wd)
        scale = 2 ** rng.uniform(self.cfg.min_scale, self.cfg.max_scale)
        sx = sy = scale
        if not self.sparse and rng.rand() < self.cfg.stretch_prob:
            sx *= 2 ** rng.uniform(-self.cfg.max_stretch, self.cfg.max_stretch)
            sy *= 2 ** rng.uniform(-self.cfg.max_stretch, self.cfg.max_stretch)
        return max(sx, min_scale), max(sy, min_scale)

    def _resize_sparse_flow(self, flow, valid, fx, fy, impl: Optional[str] = None):
        """Scatter-based rescale of a sparse flow map: each valid pixel moves
        to its rounded scaled position, with its flow scaled.  impl: "c"
        (the default: `native_io.scatter_resize_sparse` by the numpy
        version's rules) or "numpy", the plain version."""
        if host_c.resolve(impl, "scatter_resize_sparse") == "c":
            return native_io.scatter_resize_sparse(
                np.ascontiguousarray(flow, np.float32), np.ascontiguousarray(valid, np.float32),
                fx, fy, numpy_rules=True)
        ht, wd = flow.shape[:2]
        coords = np.stack(np.meshgrid(np.arange(wd), np.arange(ht)), axis=-1)
        coords = coords.reshape(-1, 2).astype(np.float32)
        flow_f = flow.reshape(-1, 2).astype(np.float32)
        valid_f = valid.reshape(-1).astype(np.float32)
        c0 = coords[valid_f >= 1]
        f0 = flow_f[valid_f >= 1]
        ht1, wd1 = int(round(ht * fy)), int(round(wd * fx))
        c1 = c0 * [fx, fy]
        f1 = f0 * [fx, fy]
        xx = np.round(c1[:, 0]).astype(np.int32)
        yy = np.round(c1[:, 1]).astype(np.int32)
        keep = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)
        out_flow = np.zeros([ht1, wd1, 2], np.float32)
        out_valid = np.zeros([ht1, wd1], np.int32)
        out_flow[yy[keep], xx[keep]] = f1[keep]
        out_valid[yy[keep], xx[keep]] = 1
        return out_flow, out_valid

    def _flips(self, img1, img2, flow, valid, rng):
        cfg = self.cfg
        if cfg.do_flip:
            if rng.rand() < cfg.h_flip_prob and cfg.do_flip == "hf":
                img1, img2 = img1[:, ::-1], img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
                if valid is not None:
                    valid = valid[:, ::-1]
            if rng.rand() < cfg.h_flip_prob and cfg.do_flip == "h":
                # stereo-correct horizontal flip: swap + mirror both views
                img1, img2 = img2[:, ::-1], img1[:, ::-1]
            if rng.rand() < cfg.v_flip_prob and cfg.do_flip == "v":
                img1, img2 = img1[::-1], img2[::-1]
                flow = flow[::-1] * [1.0, -1.0]
                if valid is not None:
                    valid = valid[::-1]
        return img1, img2, flow, valid

    def spatial_transform(self, img1, img2, flow, valid, crop, rng,
                          margin_crop: bool = True):
        cfg = self.cfg
        sx, sy = self._sample_scales(img1.shape[0], img1.shape[1], crop, rng)
        if rng.rand() < self.spatial_prob:
            img1 = resize(img1, None, "linear", scale=(sx, sy))
            img2 = resize(img2, None, "linear", scale=(sx, sy))
            if self.sparse:
                flow, valid = self._resize_sparse_flow(flow, valid, sx, sy)
            else:
                flow = resize(flow, None, "linear", scale=(sx, sy))
                flow = flow * [sx, sy]
        img1, img2, flow, valid = self._flips(img1, img2, flow, valid, rng)

        if self.sparse and margin_crop:
            # standard sparse path: margin-then-clip crop
            # (SparseFlowAugmentor, augmentor.py:431-438); the WoCrop
            # multi-scale path uses a plain uniform crop (:569-570)
            margin_y, margin_x = 20, 50
            y0 = rng.randint(0, img1.shape[0] - crop[0] + margin_y)
            x0 = rng.randint(-margin_x, img1.shape[1] - crop[1] + margin_x)
            y0 = int(np.clip(y0, 0, img1.shape[0] - crop[0]))
            x0 = int(np.clip(x0, 0, img1.shape[1] - crop[1]))
            y1 = y0
        elif self.sparse:
            y0 = rng.randint(0, img1.shape[0] - crop[0] + 1)
            x0 = rng.randint(0, img1.shape[1] - crop[1] + 1)
            y1 = y0
        elif cfg.yjitter:
            y0 = rng.randint(2, img1.shape[0] - crop[0] - 2)
            x0 = rng.randint(2, img1.shape[1] - crop[1] - 2)
            y1 = y0 + rng.randint(-2, 3)  # imperfect-rectification jitter
        else:
            y0 = rng.randint(0, img1.shape[0] - crop[0])
            x0 = rng.randint(0, img1.shape[1] - crop[1])
            y1 = y0
        img1 = img1[y0 : y0 + crop[0], x0 : x0 + crop[1]]
        img2 = img2[y1 : y1 + crop[0], x0 : x0 + crop[1]]
        flow = flow[y0 : y0 + crop[0], x0 : x0 + crop[1]]
        if valid is not None:
            valid = valid[y0 : y0 + crop[0], x0 : x0 + crop[1]]
        return img1, img2, flow, valid

    # -- entry points ----------------------------------------------- #

    def __call__(
        self,
        img1: np.ndarray,
        img2: np.ndarray,
        flow: np.ndarray,
        valid: Optional[np.ndarray] = None,
        crop_size: Optional[Tuple[int, int]] = None,
        scale_size: Optional[Tuple[int, int]] = None,
        rng: Optional[np.random.RandomState] = None,
    ):
        """crop_size overrides the config crop (multi-scale HR crop);
        scale_size, when given, bicubic-downscales the IMAGES ONLY to the LR
        input size afterwards (the WoCrop behavior, augmentor.py:306-318)."""
        rng = rng or np.random.RandomState()
        crop = tuple(crop_size or self.cfg.crop_size)
        img1, img2 = self.color_transform(img1, img2, rng)
        img1, img2 = self.eraser_transform(img1, img2, rng)
        img1, img2, flow, valid = self.spatial_transform(
            img1, img2, flow, valid, crop, rng,
            margin_crop=scale_size is None,
        )
        if scale_size is not None:
            img1 = resize(img1, (scale_size[1], scale_size[0]), "cubic")
            img2 = resize(img2, (scale_size[1], scale_size[0]), "cubic")
        out = tuple(
            np.ascontiguousarray(x) for x in (img1, img2, flow)
        )
        if self.sparse:
            return (*out, np.ascontiguousarray(valid))
        return out
