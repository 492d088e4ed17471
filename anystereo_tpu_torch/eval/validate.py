"""Held-out-split validation (twin of `anystereo_tpu/eval/validate.py`): the
protocol every reported number comes from.

Per image: pad to divisibility (32 for the IGEV core, 16 otherwise), run the
model in eval mode with `valid_iters` GRU iterations, decode densely at the
original resolution (or at an arbitrary-scale grid), mask, and aggregate
EPE / D1 / Thres{1,2,3} per image.  The arbitrary-scale protocol
(`scale_test > 1`) bicubic-downscales the inputs by `scale_test` and decodes
the original-resolution grid, which exercises the implicit decoder's
super-resolution.

Valid mask: by default the dataset's own `valid` channel; `valid_from_gt`
derives it from the ground truth over all pixels (finite, > 0, < max_disp),
which Middlebury and ETH3D need (their readers hand out the non-occluded
mask as `valid`).

Occlusion splits: KITTI compares its disp_occ and disp_noc ground truth;
Middlebury and ETH3D read mask0nocc.png beside disp0GT.pfm; SceneFlow uses
the left-right consistency check (`eval/occlusion.occ_mask`, one launch of
`gather_rows_linear` a frame on the card) when the right view's ground truth
exists.  Middlebury 2014 (disp0.pfm) has no occlusion ground truth.

`build_eval_dataset` resolves a dataset name to its dataset and protocol,
`make_train_validate_fn` gives the trainer its validation hook and
`run_validation` evaluates a checkpoint.  Images are resized by
`utils/resize` and files read by `data/` (the port needs no OpenCV or PIL).
"""

from __future__ import annotations

import functools
import logging
import math
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from anystereo_tpu_torch.config import CoreType, ModelConfig
from anystereo_tpu_torch.data.datasets import ETH3D, KittiMixed, Middlebury, SceneFlowDataset
from anystereo_tpu_torch.data.frame_utils import read_pfm
from anystereo_tpu_torch.data.png import read_png
from anystereo_tpu_torch.eval import reporting
from anystereo_tpu_torch.eval.metrics import AverageMeterDict, compute_metrics
from anystereo_tpu_torch.eval.occlusion import occ_mask
from anystereo_tpu_torch.eval.padder import InputPadder
from anystereo_tpu_torch.nn.model import AnyStereo, build_model
from anystereo_tpu_torch.ops.coords import make_coord
from anystereo_tpu_torch.train.state import restore_eval_variables
from anystereo_tpu_torch.utils.device import model_device, resolve_device
from anystereo_tpu_torch.utils.resize import resize

log = logging.getLogger(__name__)


def _pad_pair(left, right, divis: int, dev):
    """[1, H, W, 3] numpy pair → ((top, bottom, left, right) padding, left_pad,
    right_pad), float32 on `dev`."""
    padder = InputPadder(left.shape, divis_by=divis)
    left_p, right_p = padder.pad(*(torch.as_tensor(x, dtype=torch.float32, device=dev)
                                   for x in (left, right)))
    return padder.get_pad_num(), left_p, right_p


def _pad_common(left, right, scale_test: float, divis: int, device=None):
    """left/right: [1, H, W, 3] numpy.  Downscale by `scale_test` (bicubic),
    pad to `divis` on `device`.  Returns (left_pad, right_pad, the wanted
    (H, W), the padded frame at the output scale, its (top, bottom, left,
    right) padding at that scale)."""
    assert scale_test > 0.99
    dev = resolve_device(device)
    h_want, w_want = left.shape[1:3]
    h_lr = int(math.ceil(h_want / float(scale_test)))
    w_lr = int(math.ceil(w_want / float(scale_test)))
    if scale_test > 1:
        left = resize(left[0], (w_lr, h_lr), "cubic")[None]
        right = resize(right[0], (w_lr, h_lr), "cubic")[None]
    (t, b, l, r), left_p, right_p = _pad_pair(left, right, divis, dev)
    h_hr_pad = round(left_p.shape[1] * scale_test)
    w_hr_pad = round(left_p.shape[2] * scale_test)
    if scale_test > 1:
        t, b, l, r = (round(i * scale_test) for i in (t, b, l, r))
    return left_p, right_p, (h_want, w_want), (h_hr_pad, w_hr_pad), (t, b, l, r)


def _axis_centers_np(n: int) -> np.ndarray:
    r = 1.0 / n
    return (-1 + r + 2 * r * np.arange(n)).astype(np.float32)


def pad_for_queries(left, right, scale_test: float, divis: int, device=None):
    """Downscale the inputs by `scale_test`, pad to divisibility, and build
    queries over the original (unpadded, full-resolution) pixel grid inside
    the padded frame.  left/right: [1, H, W, 3] numpy.  Returns (left_pad,
    right_pad, coords [1, H*W, 2], scale)."""
    left_p, right_p, (h_want, w_want), (hp, wp), (t, b, l, r) = _pad_common(
        left, right, scale_test, divis, device)
    grid = make_coord((hp, wp), flatten=False).numpy()
    grid = grid[t : hp - b, l : wp - r]
    if grid.shape[:2] != (h_want, w_want):  # off by a rounding: stretch to the wanted grid
        grid = resize(grid, (w_want, h_want), "linear")
    coords = torch.as_tensor(grid.reshape(1, h_want * w_want, 2), device=left_p.device)
    return left_p, right_p, coords, float(scale_test)


def _fit(axis: np.ndarray, n: int) -> np.ndarray:
    """`axis` stretched linearly to n entries when a rounding left it off."""
    if len(axis) == n:
        return axis
    return resize(axis.reshape(-1, 1), (1, n), "linear").ravel()


def pad_for_dense_grid(left, right, scale_test: float, divis: int, device=None):
    """Separable twin of `pad_for_queries`: the cropped query grid is an
    outer product of per-axis center sequences, so return (left_pad,
    right_pad, ys [H], xs [W], scale) for the dense decode."""
    left_p, right_p, (h_want, w_want), (hp, wp), (t, b, l, r) = _pad_common(
        left, right, scale_test, divis, device)
    ys = _fit(_axis_centers_np(hp)[t : hp - b], h_want)
    xs = _fit(_axis_centers_np(wp)[l : wp - r], w_want)
    dev = left_p.device
    return left_p, right_p, torch.as_tensor(ys, device=dev), torch.as_tensor(xs, device=dev), \
        float(scale_test)


def pad_for_fixed_upscale(left, right, up: int, divis: int = 16, device=None):
    """The inputs are not downscaled; the decoder queries an exact `up`-times
    grid over the padded frame, cropped to `up` times the original extent
    (the Middlebury quarter-to-full and half-to-full protocols).  Returns
    (left_pad, right_pad, ys, xs, scale=up)."""
    dev = resolve_device(device)
    (t, b, l, r), left_p, right_p = _pad_pair(left, right, divis, dev)
    hp, wp = left_p.shape[1] * up, left_p.shape[2] * up
    ys = _axis_centers_np(hp)[t * up : hp - b * up]
    xs = _axis_centers_np(wp)[l * up : wp - r * up]
    assert len(ys) == left.shape[1] * up and len(xs) == left.shape[2] * up
    return left_p, right_p, torch.as_tensor(ys, device=dev), torch.as_tensor(xs, device=dev), \
        float(up)


def _lr_occlusion(dl: np.ndarray, dr: np.ndarray, dev) -> np.ndarray:
    dl, dr = (torch.as_tensor(np.asarray(d), dtype=torch.float32, device=dev)[None] for d in (dl, dr))
    return occ_mask(dl, dr)[0].cpu().numpy()


def lr_consistency_occ_provider(device=None) -> Callable:
    """An occlusion provider for datasets that hold the right view's ground
    truth in memory: a pixel is occluded when the right-view disparity
    warped to the left disagrees with the left one by more than 3 px.  The
    dataset gives the pair as `disparity_pair(index)` → (left [H, W], right
    [H, W]) numpy, or None; the mask is computed on `device`."""
    dev = resolve_device(device)

    def provider(dataset, index) -> Optional[np.ndarray]:
        pair = dataset.disparity_pair(index) if hasattr(dataset, "disparity_pair") else None
        return None if pair is None else _lr_occlusion(*pair, dev)

    return provider


def kitti_occ_provider(dataset, index) -> Optional[np.ndarray]:
    """Occlusion mask for KITTI: True where the disp_occ and disp_noc ground
    truth images differ (the pixels only the occluded ground truth covers)."""
    occ_path = dataset.disparity_list[index]
    noc_path = occ_path.replace("disp_occ_0", "disp_noc_0").replace("disp_occ", "disp_noc")
    if noc_path == occ_path or not os.path.exists(noc_path):
        return None
    return read_png(occ_path) != read_png(noc_path)


def sceneflow_occ_provider(dataset, index, device=None) -> Optional[np.ndarray]:
    """SceneFlow: occlusion by left-right consistency of the ground truth
    PFMs (the right view's beside the left's), computed on `device`
    (default: the CUDA card)."""
    left_path = dataset.disparity_list[index]
    right_path = left_path.replace("/left/", "/right/")
    if right_path == left_path or not os.path.exists(right_path):
        return None
    return _lr_occlusion(read_pfm(left_path), read_pfm(right_path), resolve_device(device))


def nocc_mask_occ_provider(dataset, index) -> Optional[np.ndarray]:
    """Middlebury/ETH3D: occluded = complement of mask0nocc.png beside
    disp0GT.pfm (`== 255` is non-occluded; a colour mask counts by its
    luminance).  Middlebury 2014 (disp0.pfm) ships no occlusion ground
    truth: None, rather than its reader's disp < 1e3 validity mask.  A reader
    that returns (disp, nocc) gives the mask otherwise."""
    path = dataset.disparity_list[index]
    mask_path = path.replace("disp0GT.pfm", "mask0nocc.png")
    if mask_path != path and os.path.exists(mask_path):
        return _luminance(read_png(mask_path)) != 255
    if os.path.basename(path) == "disp0.pfm":
        return None
    disp = dataset.reader(path)
    if isinstance(disp, tuple):
        _, nocc = disp
        return ~np.asarray(nocc, bool)
    return None


def _luminance(img: np.ndarray) -> np.ndarray:
    """PIL's `convert("L")` of a gray, gray+alpha, RGB or RGBA uint8 image:
    (19595 R + 38470 G + 7471 B + 2^15) >> 16 for colour, the gray channel
    otherwise."""
    if img.ndim == 2:
        return img
    if img.shape[-1] <= 2:
        return img[..., 0]
    x = img[..., :3].astype(np.int64)
    return ((19595 * x[..., 0] + 38470 * x[..., 1] + 7471 * x[..., 2] + 0x8000) >> 16).astype(np.uint8)


class Validator:
    """Per-image inference by the evaluation protocol.  `model` must lie on
    `device` (default: the CUDA card; the CPU only when asked for by name).

    bucket: pad the inputs up to multiples of `bucket` (a multiple of the
    model's divis) instead of the minimal padding, decode the whole padded
    grid and crop on the host.  The JAX package buckets so that images of
    mixed sizes share compiled programs; nothing is compiled here, and the
    option stays so that a run reproduces that protocol's numbers: the extra
    rows and columns are replicated edges, so results equal the unbucketed
    ones up to what the border context changes.  Off by default."""

    def __init__(self, model: AnyStereo, valid_iters: int = 32, bucket: Optional[int] = None,
                 device=None):
        self.model = model
        self.valid_iters = valid_iters
        self.bucket = bucket
        self.device = model_device(model, device)

    def _decode(self, lp, rp, ys, xs, scale: float) -> np.ndarray:
        out = self.model(lp, rp, iters=self.valid_iters, scale=scale, mode="eval",
                         dense_grid=(ys, xs))
        return out.disp_final[0].float().cpu().numpy()

    def infer(self, left: np.ndarray, right: np.ndarray, scale_test: float = 1.0,
              divis: int = 32, fixed_upscale: Optional[int] = None,
              eval_others: bool = False) -> np.ndarray:
        """left/right [H, W, 3] → disparity at the original resolution (or
        `fixed_upscale` times it), by the dense decode.

        eval_others: the comparison protocol for models without an implicit
        decoder: bicubic-downscale the inputs by `scale_test`, run plain
        full-resolution inference on the low-resolution pair, multiply the
        disparity by `scale_test` and bicubic-upscale it to the original
        grid."""
        left = np.asarray(left, np.float32)
        right = np.asarray(right, np.float32)
        if self.bucket is not None and not (eval_others and scale_test > 1):
            assert self.bucket % divis == 0, (self.bucket, divis)
            assert scale_test == 1.0, "shape bucketing supports scale_test=1 / fixed-upscale only"
            up = 1 if fixed_upscale is None else int(fixed_upscale)
            (t, b, l, r), lp, rp = _pad_pair(left[None], right[None], self.bucket, self.device)
            hp, wp = lp.shape[1] * up, lp.shape[2] * up
            ys = torch.as_tensor(_axis_centers_np(hp), device=self.device)
            xs = torch.as_tensor(_axis_centers_np(wp), device=self.device)
            disp = self._decode(lp, rp, ys, xs, float(up))
            return disp[t * up : hp - b * up, l * up : wp - r * up]
        if eval_others and scale_test > 1:
            h, w = left.shape[:2]
            h_lr = int(math.ceil(h / float(scale_test)))
            w_lr = int(math.ceil(w / float(scale_test)))
            pred_lr = self.infer(resize(left, (w_lr, h_lr), "cubic"),
                                 resize(right, (w_lr, h_lr), "cubic"), 1.0, divis)
            return resize(pred_lr * float(scale_test), (w, h), "cubic")
        if fixed_upscale is not None:
            lp, rp, ys, xs, s = pad_for_fixed_upscale(left[None], right[None], fixed_upscale, divis,
                                                      self.device)
        else:
            lp, rp, ys, xs, s = pad_for_dense_grid(left[None], right[None], scale_test, divis,
                                                   self.device)
        return self._decode(lp, rp, ys, xs, s)


def validate_dataset(
    model: AnyStereo,
    dataset,
    valid_iters: int = 32,
    scale_test: float = 1.0,
    divis: int = 32,
    max_disp: float = 1000.0,
    max_images: Optional[int] = None,
    fixed_upscale: Optional[int] = None,
    report_dir: Optional[str] = None,
    dump_images: bool = False,
    occ_provider=None,
    valid_from_gt: bool = False,
    eval_others: bool = False,
    bucket: Optional[int] = None,
    device=None,
) -> Dict[str, float]:
    """Per-image validation over `dataset`: any object with `__len__`,
    `_load_raw(i)` → (left [H, W, 3], right, flow [H, W, 2] with the
    disparity in channel 0, valid [H, W]), `image_list` and
    `disparity_list`, giving full-resolution samples (with `fixed_upscale`,
    ground truth at that multiple of the input resolution).  Returns the mean
    of every per-image metric.

    occ_provider(dataset, i) → boolean [H, W] (True = occluded) or None adds
    the `_occ` / `_noc` metrics.  valid_from_gt, eval_others, bucket: see the
    module docstring and `Validator`.  report_dir: append a line a frame and
    a summary to `report_dir/result.txt`; with dump_images also write each
    frame's coloured disparity and error map to `report_dir/output/`.
    `model` must lie on `device` (default: the CUDA card)."""
    vd = Validator(model, valid_iters, bucket=bucket, device=device)
    dev = vd.device
    meter = AverageMeterDict()
    n = len(dataset) if max_images is None else min(len(dataset), max_images)
    for i in range(n):
        img1, img2, flow, valid = dataset._load_raw(i)
        gt = np.asarray(flow[..., 0], np.float32)
        pred = vd.infer(img1, img2, scale_test, divis, fixed_upscale, eval_others=eval_others)
        if valid_from_gt:
            vmask = np.isfinite(gt) & (gt > 0) & (gt < max_disp)
        else:
            vmask = (np.asarray(valid) > 0) & (gt > 0) & (gt < max_disp)
        occ = occ_provider(dataset, i) if occ_provider is not None else None
        m = compute_metrics(
            torch.as_tensor(pred, device=dev)[None],
            torch.as_tensor(gt, device=dev)[None],
            torch.as_tensor(vmask, device=dev)[None],
            None if occ is None else torch.as_tensor(np.asarray(occ, bool), device=dev)[None],
        )
        meter.update(m)
        if report_dir is not None:
            name = os.path.basename(os.path.dirname(dataset.image_list[i][0]))
            name = f"{name}_{i:04d}"
            reporting.append_result_line(os.path.join(report_dir, "result.txt"), name,
                                         {k: float(v) for k, v in m.items()})
            if dump_images:
                out = os.path.join(report_dir, "output")
                reporting.dump_disparity_png(out, name, pred)
                reporting.dump_error_map_png(out, name, pred, gt, vmask)
        if (i + 1) % 20 == 0:
            log.info("validate %d/%d: %s", i + 1, n, meter.mean())
    results = meter.mean()
    if report_dir is not None:
        reporting.write_summary(os.path.join(report_dir, "result.txt"), results, header="summary")
    return results


def build_eval_dataset(dataset: str, data_root: str, device=None):
    """Resolve a validation-dataset name to (dataset, fixed_upscale,
    occ_provider, valid_from_gt), shared by `run_validation` and the
    in-training validation hook.  valid_from_gt is True for Middlebury and
    ETH3D (see `validate_dataset`); the SceneFlow occlusion provider computes
    on `device` (default: the CUDA card)."""
    fixed_upscale = None
    if dataset == "sceneflow":
        ds = SceneFlowDataset(data_root, aug=None, things_test=True)
    elif dataset == "kitti15":
        ds = KittiMixed(data_root, data_root, aug=None, mode="valid_15")
    elif dataset == "kitti12":
        ds = KittiMixed(data_root, data_root, aug=None, mode="valid_12")
    elif dataset in ("middlebury_Q_F", "middlebury_H_F"):
        # the fixed-scale arbitrary-scale protocol: inputs from the Q/H
        # split, ground truth from the F split, decoded at 4x / 2x
        src = dataset.split("_")[1]
        fixed_upscale = 4 if src == "Q" else 2
        ds = Middlebury(data_root, aug=None, split=src)
        full = Middlebury(data_root, aug=None, split="F")
        ds.disparity_list = full.disparity_list
    elif dataset.startswith("middlebury_"):
        ds = Middlebury(data_root, aug=None, split=dataset.split("_")[1])
    elif dataset == "eth3d":
        ds = ETH3D(data_root, aug=None)
    else:
        raise ValueError(dataset)

    occ_provider = None
    valid_from_gt = False
    if dataset.startswith("kitti"):
        occ_provider = kitti_occ_provider
    elif dataset.startswith("middlebury") or dataset == "eth3d":
        occ_provider = nocc_mask_occ_provider
        valid_from_gt = True
    elif dataset == "sceneflow":
        occ_provider = functools.partial(sceneflow_occ_provider, device=resolve_device(device))
    return ds, fixed_upscale, occ_provider, valid_from_gt


def _divis(cfg: ModelConfig) -> int:
    return 32 if cfg.core is CoreType.IGEV else 16


def make_train_validate_fn(model_cfg: ModelConfig, dataset: str, data_root: str, valid_iters: int = 32,
                           max_images: Optional[int] = None, device=None):
    """A `validate_fn(state, step)` for the training loop: the held-out split
    of `dataset` with the state's current weights; returns the metric dict.
    `model_cfg` is the trained model's configuration; the state's model must
    lie on `device` (default: the CUDA card)."""
    ds, fixed_upscale, occ_provider, valid_from_gt = build_eval_dataset(dataset, data_root, device)
    divis = _divis(model_cfg)

    def validate_fn(state, step: int) -> Dict[str, float]:
        return validate_dataset(
            state.model, ds, valid_iters, divis=divis, max_images=max_images,
            fixed_upscale=fixed_upscale, occ_provider=occ_provider, valid_from_gt=valid_from_gt,
            device=device)

    return validate_fn


def run_validation(
    model_cfg: ModelConfig,
    ckpt_dir: str,
    dataset: str,
    data_root: str,
    valid_iters: int = 32,
    scale_test: float = 1.0,
    max_images: Optional[int] = None,
    eval_others: bool = False,
    bucket: Optional[int] = None,
    device=None,
) -> Dict[str, float]:
    """Build the dataset and the model on `device` (default: the CUDA card),
    load the latest checkpoint's weights from `ckpt_dir`, validate."""
    ds, fixed_upscale, occ_provider, valid_from_gt = build_eval_dataset(dataset, data_root, device)
    model = restore_eval_variables(ckpt_dir, build_model(model_cfg, device))
    return validate_dataset(
        model, ds, valid_iters, scale_test, _divis(model_cfg), max_images=max_images,
        fixed_upscale=fixed_upscale, occ_provider=occ_provider, valid_from_gt=valid_from_gt,
        eval_others=eval_others, bucket=bucket, device=device)
