"""Dataset classes (twin of `anystereo_tpu/data/datasets.py`): path
discovery, ground-truth readers and the three sample modes.

  * standard mode: dense augmented crops;
  * multi-scale mode: a random scale in [scale_min, scale_max], a
    high-resolution crop of round(inp_size * scale), images downscaled to
    inp_size, the ground truth as (coordinate, value) query pairs with a
    static sample_q = inp_size[0] * inp_size[1] subsample (valid-first for
    sparse ground truth), plus the 1/4-resolution ground truth divided by
    4 * scale for the initial disparity's supervision;
  * multi-input mode: the standard crop with its inputs downscaled by a
    random scale and padded back, queried on the crop's own grid.

The dataset classes keep their split conventions: SceneFlow's seed-1000
validation permutation, KITTI's seed-1000 held-out 14 + 20 images,
Middlebury's MiddEval3 and 2014 exposure variants; `fetch_dataset` maps
names to datasets.  Globs are sorted as the JAX package sorts them.
Outputs are numpy dicts, batched by `data.loader`.
"""

from __future__ import annotations

import copy
import logging
import os.path as osp
from glob import glob
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from anystereo_tpu_torch.data import frame_utils
from anystereo_tpu_torch.data.augment import AugmentorConfig, StereoAugmentor
from anystereo_tpu_torch.utils.resize import resize

log = logging.getLogger(__name__)


def make_coord_np(shape: Sequence[int]) -> np.ndarray:
    """Pixel-center coords in [-1,1], (y, x) order → [H*W, 2] (the numpy
    twin of ops.coords.make_coord, stereo_datasets.py:18-33)."""
    axes = []
    for n in shape:
        r = 1.0 / n
        axes.append(-1 + r + 2 * r * np.arange(n, dtype=np.float32))
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return grid.reshape(-1, grid.shape[-1])


class StereoDataset:
    def __init__(
        self,
        aug: Optional[AugmentorConfig] = None,
        sparse: bool = False,
        reader=None,
        multi_scale: bool = False,
        multi_input: bool = False,
        scale_min: float = 1.0,
        scale_max: float = 4.0,
        inp_size: Tuple[int, int] = (160, 320),
    ):
        self.sparse = sparse
        self.augmentor = StereoAugmentor(aug, sparse=sparse) if aug else None
        self.reader = reader or frame_utils.read_gen
        self.multi_scale = multi_scale
        self.multi_input = multi_input
        self.scale_min = scale_min
        self.scale_max = scale_max
        self.inp_size = tuple(inp_size)
        self.sample_q = inp_size[0] * inp_size[1]
        self.image_list: List[List[str]] = []
        self.disparity_list: List[str] = []
        self.extra_info: List = []

    # ------------------------------------------------------------- #

    def _load_raw(self, index: int):
        index = index % len(self.image_list)
        disp = self.reader(self.disparity_list[index])
        if isinstance(disp, tuple):
            disp, valid = disp
        else:
            valid = disp < 512  # dense-GT validity ceiling (:103)
        img1 = np.asarray(frame_utils.read_gen(self.image_list[index][0]))
        img2 = np.asarray(frame_utils.read_gen(self.image_list[index][1]))
        if img1.ndim == 2:
            img1 = np.tile(img1[..., None], (1, 1, 3))
            img2 = np.tile(img2[..., None], (1, 1, 3))
        else:
            img1, img2 = img1[..., :3], img2[..., :3]
        disp = np.asarray(disp, np.float32)
        flow = np.stack([disp, np.zeros_like(disp)], axis=-1)
        return img1.astype(np.uint8), img2.astype(np.uint8), flow, valid

    def __getitem__(self, index: int, rng: Optional[np.random.RandomState] = None):
        rng = rng or np.random.RandomState()
        img1, img2, flow, valid = self._load_raw(index)

        if not self.multi_scale:
            if self.augmentor is not None:
                if self.sparse:
                    img1, img2, flow, valid = self.augmentor(
                        img1, img2, flow, valid, rng=rng
                    )
                else:
                    img1, img2, flow = self.augmentor(img1, img2, flow, rng=rng)
                    valid = (np.abs(flow[..., 0]) < 512).astype(np.float32)
            if self.multi_input:
                return self._multi_input_sample(img1, img2, flow, valid, rng)
            return {
                "left": img1.astype(np.float32),
                "right": img2.astype(np.float32),
                "disp": flow[..., 0].astype(np.float32),
                "valid": np.asarray(valid, np.float32),
            }

        # ---- multi-scale (arbitrary-scale) training sample ---------- #
        if self.scale_min != self.scale_max:
            scale = rng.uniform(self.scale_min, self.scale_max)
        else:
            scale = self.scale_max
        h_lr, w_lr = self.inp_size
        h_hr, w_hr = round(h_lr * scale), round(w_lr * scale)

        if self.sparse:
            img1, img2, flow, valid = self.augmentor(
                img1, img2, flow, valid,
                crop_size=(h_hr, w_hr), scale_size=(h_lr, w_lr), rng=rng,
            )
        else:
            img1, img2, flow = self.augmentor(
                img1, img2, flow, crop_size=(h_hr, w_hr), scale_size=(h_lr, w_lr),
                rng=rng,
            )

        disp_hr = flow[..., 0]  # [h_hr, w_hr]
        if self.sparse:
            # the reference skips flow_low_res entirely on the sparse
            # multi-training path (stereo_datasets.py:188); a plain
            # INTER_LINEAR resize would average valid disparities with the
            # zero-filled invalid pixels and supervise init_disp toward ~0.
            # Here: valid-aware block mean, with empty cells set to a
            # sentinel the init-disp loss mask (gt_low < max_disp/4)
            # excludes — supervise_init works for sparse data too.
            lh, lw = h_lr // 4, w_lr // 4
            ys, xs = np.nonzero(disp_hr > 0)
            yy = np.clip((ys * (lh / disp_hr.shape[0])).astype(np.int64), 0, lh - 1)
            xx = np.clip((xs * (lw / disp_hr.shape[1])).astype(np.int64), 0, lw - 1)
            acc = np.zeros((lh, lw), np.float64)
            cnt = np.zeros((lh, lw), np.float64)
            np.add.at(acc, (yy, xx), disp_hr[ys, xs])
            np.add.at(cnt, (yy, xx), 1.0)
            low = np.where(
                cnt > 0, acc / np.maximum(cnt, 1.0) / (4.0 * scale), 1e9
            ).astype(np.float32)
        else:
            low = resize(disp_hr, (w_lr // 4, h_lr // 4), "linear") / (4.0 * scale)

        coords = make_coord_np(disp_hr.shape)  # [h_hr*w_hr, 2]
        values = disp_hr.reshape(-1)

        if self.sparse:
            # valid-first packing (:170-187): all valid queries, padded with
            # invalid ones; valid flag derived from GT > 0
            vmask = values > 0.0
            v_idx = np.nonzero(vmask)[0]
            iv_idx = np.nonzero(~vmask)[0]
            if self.sample_q < len(v_idx):
                sel = rng.choice(len(v_idx), self.sample_q, replace=False)
                idx = v_idx[sel]
            else:
                pad = rng.choice(len(iv_idx), self.sample_q - len(v_idx), replace=False)
                idx = np.concatenate([v_idx, iv_idx[pad]])
            qvalid = vmask[idx].astype(np.float32)
        else:
            idx = rng.choice(len(coords), self.sample_q, replace=False)
            qvalid = np.ones(self.sample_q, np.float32)

        return {
            "left": img1.astype(np.float32),
            "right": img2.astype(np.float32),
            "coords": coords[idx],
            "gt": values[idx].astype(np.float32),
            "valid": qvalid,
            "scale": np.float32(scale),
            "gt_low": low.astype(np.float32),
        }

    def _multi_input_sample(self, img1, img2, flow, valid, rng):
        """multi_input_training sample (stereo_datasets.py:213-235): after
        the standard crop, bicubic-downscale the inputs by a random scale,
        replicate-pad back to the crop size, and emit the query grid of the
        original (crop-res) pixels inside the scale-x padded frame.  GT is
        the full crop-res disparity → Q = crop_h * crop_w (static)."""
        import math

        h_want, w_want = img1.shape[:2]
        scale = rng.uniform(self.scale_min, self.scale_max)
        h_lr = int(math.ceil(h_want / scale))
        w_lr = int(math.ceil(w_want / scale))
        im1 = resize(img1, (w_lr, h_lr), "cubic")
        im2 = resize(img2, (w_lr, h_lr), "cubic")
        pad_ht, pad_wd = h_want - h_lr, w_want - w_lr
        t, b = pad_ht // 2, pad_ht - pad_ht // 2
        l, r = pad_wd // 2, pad_wd - pad_wd // 2
        im1 = np.pad(im1, ((t, b), (l, r), (0, 0)), mode="edge")
        im2 = np.pad(im2, ((t, b), (l, r), (0, 0)), mode="edge")
        h_hr_pad = int(math.ceil(h_want * scale))
        w_hr_pad = int(math.ceil(w_want * scale))
        grid = make_coord_np((h_hr_pad, w_hr_pad)).reshape(h_hr_pad, w_hr_pad, 2)
        st, sb = int(math.ceil(t * scale)), int(math.ceil(b * scale))
        sl, sr = int(math.ceil(l * scale)), int(math.ceil(r * scale))
        grid = grid[st : h_hr_pad - sb, sl : w_hr_pad - sr]
        if grid.shape[:2] != (h_want, w_want):
            grid = resize(grid, (w_want, h_want), "linear")
        return {
            "left": im1.astype(np.float32),
            "right": im2.astype(np.float32),
            "coords": grid.reshape(-1, 2).astype(np.float32),
            "gt": flow[..., 0].reshape(-1).astype(np.float32),
            "valid": np.asarray(valid, np.float32).reshape(-1),
            "scale": np.float32(scale),
            "gt_low": resize(flow[..., 0], (w_want // 4, h_want // 4), "linear")
            / np.float32(4.0 * scale),
        }

    def __mul__(self, v: int) -> "StereoDataset":
        out = copy.copy(self)
        out.image_list = v * self.image_list
        out.disparity_list = v * self.disparity_list
        out.extra_info = v * self.extra_info
        return out

    def __add__(self, other) -> "ConcatStereoDataset":
        return ConcatStereoDataset([self, other])

    def __len__(self) -> int:
        return len(self.image_list)


class ConcatStereoDataset:
    """Datasets one after the other, each sample made by the dataset it comes
    from (its ground-truth reader, sparsity and augmentor), as the
    reference's `a + b` (`torch.utils.data.ConcatDataset`) makes it.  The
    JAX package's `StereoDataset.__add__` instead copies the first dataset
    with the lists joined, so a mix reads every sample with the first
    dataset's reader (SceneFlow's `read_gen` takes FallingThings' depth PNG
    for its disparity)."""

    def __init__(self, parts: Sequence):
        self.parts = [q for p in parts for q in (p.parts if isinstance(p, ConcatStereoDataset) else [p])]
        self.ends = np.cumsum([len(p) for p in self.parts])

    def _locate(self, index: int):
        index = int(index) % len(self)
        k = int(np.searchsorted(self.ends, index, side="right"))
        return self.parts[k], index - (int(self.ends[k - 1]) if k else 0)

    @property
    def image_list(self) -> List[List[str]]:
        return [e for p in self.parts for e in p.image_list]

    @property
    def disparity_list(self) -> List[str]:
        return [e for p in self.parts for e in p.disparity_list]

    @property
    def extra_info(self) -> List:
        return [e for p in self.parts for e in p.extra_info]

    def _load_raw(self, index: int):
        part, i = self._locate(index)
        return part._load_raw(i)

    def __getitem__(self, index: int, rng: Optional[np.random.RandomState] = None):
        part, i = self._locate(index)
        return part.__getitem__(i, rng=rng)

    def __add__(self, other) -> "ConcatStereoDataset":
        return ConcatStereoDataset([self, other])

    def __mul__(self, v: int) -> "ConcatStereoDataset":
        return ConcatStereoDataset(self.parts * v)

    def __len__(self) -> int:
        return int(self.ends[-1]) if len(self.ends) else 0


# ------------------------------------------------------------------ #
# concrete datasets
# ------------------------------------------------------------------ #


class SceneFlowDataset(StereoDataset):
    """FlyingThings3D + Monkaa + Driving, finalpass; glob layout and the
    seed-1000 validation convention of stereo_datasets.py:252-314."""

    def __init__(self, root: str, aug=None, dstype="frames_finalpass",
                 things_test=False, **kw):
        super().__init__(aug, **kw)
        self.root, self.dstype = root, dstype
        if things_test:
            self._add_things("TEST")
        else:
            self._add_things("TRAIN")
            self._add_monkaa()
            self._add_driving()

    def _pairs(self, pattern):
        left = sorted(glob(osp.join(self.root, self.dstype, pattern)))
        right = [p.replace("left", "right") for p in left]
        disp = [
            p.replace(self.dstype, "disparity").replace(".png", ".pfm") for p in left
        ]
        return left, right, disp

    def _add_things(self, split):
        left, right, disp = self._pairs(f"{split}/*/*/left/*.png")
        # seed-1000 permutation (:275-278).  NOTE the reference takes
        # set(permutation(N)) — i.e. every TEST index — reproduced as-is.
        state = np.random.get_state()
        np.random.seed(1000)
        val_idxs = set(np.random.permutation(len(left)))
        np.random.set_state(state)
        for i, (l, r, d) in enumerate(zip(left, right, disp)):
            if (split == "TEST" and i in val_idxs) or split == "TRAIN":
                self.image_list.append([l, r])
                self.disparity_list.append(d)

    def _add_monkaa(self):
        left, right, disp = self._pairs("TRAIN/*/left/*.png")
        for l, r, d in zip(left, right, disp):
            self.image_list.append([l, r])
            self.disparity_list.append(d)

    def _add_driving(self):
        left, right, disp = self._pairs("TRAIN/*/*/*/left/*.png")
        for l, r, d in zip(left, right, disp):
            self.image_list.append([l, r])
            self.disparity_list.append(d)


class KittiDataset(StereoDataset):
    def __init__(self, root: str, aug=None, image_set="training", year=2015, **kw):
        super().__init__(aug, sparse=True, reader=frame_utils.read_disp_kitti, **kw)
        if year == 2015:
            img1 = sorted(glob(osp.join(root, image_set, "image_2/*_10.png")))
            img2 = sorted(glob(osp.join(root, image_set, "image_3/*_10.png")))
            disp = sorted(glob(osp.join(root, "training", "disp_occ_0/*_10.png")))
        else:
            img1 = sorted(glob(osp.join(root, image_set, "colored_0/*_10.png")))
            img2 = sorted(glob(osp.join(root, image_set, "colored_1/*_10.png")))
            disp = sorted(glob(osp.join(root, "training", "disp_occ/*_10.png")))
        if image_set != "training":
            disp = disp[:1] * len(img1) if disp else []
        for l, r, d in zip(img1, img2, disp):
            self.image_list.append([l, r])
            self.disparity_list.append(d)


def _kitti_heldout_indices(n12: int, n15: int):
    """Seed-1000 held-out splits: first 14 of the 2012 permutation, first 20
    of the 2015 permutation (stereo_datasets.py:419-424)."""
    state = np.random.get_state()
    np.random.seed(1000)
    val12 = set(np.random.permutation(n12)[:14])
    val15 = set(np.random.permutation(n15)[:20])
    np.random.set_state(state)
    return val12, val15


class KittiMixed(StereoDataset):
    """KITTI 2012+2015 with the reference's six modes
    (stereo_datasets.py:404-459)."""

    def __init__(self, root12: str, root15: str, aug=None, mode="mix_train", **kw):
        super().__init__(aug, sparse=True, reader=frame_utils.read_disp_kitti, **kw)
        i1_12 = sorted(glob(osp.join(root12, "training", "colored_0/*_10.png")))
        i2_12 = sorted(glob(osp.join(root12, "training", "colored_1/*_10.png")))
        d_12 = sorted(glob(osp.join(root12, "training", "disp_occ/*_10.png")))
        i1_15 = sorted(glob(osp.join(root15, "training", "image_2/*_10.png")))
        i2_15 = sorted(glob(osp.join(root15, "training", "image_3/*_10.png")))
        d_15 = sorted(glob(osp.join(root15, "training", "disp_occ_0/*_10.png")))
        val12, val15 = _kitti_heldout_indices(len(i1_12), len(i1_15))

        def add(triples, keep):
            for i, (l, r, d) in enumerate(triples):
                if keep(i):
                    self.image_list.append([l, r])
                    self.disparity_list.append(d)

        t12 = list(zip(i1_12, i2_12, d_12))
        t15 = list(zip(i1_15, i2_15, d_15))
        if mode == "mix_train":
            add(t12, lambda i: i not in val12)
            add(t15, lambda i: i not in val15)
        elif mode == "mix_train_all":
            add(t12, lambda i: True)
            add(t15, lambda i: True)
        elif mode == "valid_12":
            add(t12, lambda i: i in val12)
        elif mode == "valid_15":
            add(t15, lambda i: i in val15)
        elif mode == "12_train":
            add(t12, lambda i: True)
        elif mode == "15_train":
            add(t15, lambda i: True)
        else:
            raise ValueError(mode)


class Middlebury(StereoDataset):
    def __init__(self, root: str, aug=None, split="F", **kw):
        super().__init__(
            aug, sparse=True, reader=frame_utils.read_disp_middlebury, **kw
        )
        assert split in ("F", "H", "Q", "2014", "2014Add")
        if split in ("2014", "2014Add"):
            for scene in sorted((Path(root) / split).glob("*")):
                for s in ("E", "L", ""):  # exposure/lighting variants
                    self.image_list.append(
                        [str(scene / "im0.png"), str(scene / f"im1{s}.png")]
                    )
                    self.disparity_list.append(str(scene / "disp0.pfm"))
        else:
            names = [
                osp.basename(p) for p in glob(osp.join(root, "MiddEval3/trainingF/*"))
            ]
            for name in sorted(names):
                base = osp.join(root, "MiddEval3", f"training{split}", name)
                self.image_list.append(
                    [osp.join(base, "im0.png"), osp.join(base, "im1.png")]
                )
                self.disparity_list.append(osp.join(base, "disp0GT.pfm"))


class ETH3D(StereoDataset):
    def __init__(self, root: str, aug=None, split="training", **kw):
        super().__init__(aug, sparse=True, **kw)
        img1 = sorted(glob(osp.join(root, f"two_view_{split}/*/im0.png")))
        img2 = sorted(glob(osp.join(root, f"two_view_{split}/*/im1.png")))
        if split == "training":
            disp = sorted(
                glob(osp.join(root, "two_view_training_gt/*/disp0GT.pfm"))
            )
        else:
            # non-training splits have no GT: the reference pairs every
            # image with one fixed dummy GT (stereo_datasets.py:323) —
            # zipping against training GTs would pair unrelated scenes
            disp = [
                osp.join(root, "two_view_training_gt/playground_1l/disp0GT.pfm")
            ] * len(img1)
        for l, r, d in zip(img1, img2, disp):
            self.image_list.append([l, r])
            self.disparity_list.append(d)


class SintelStereo(StereoDataset):
    def __init__(self, root: str, aug=None, **kw):
        super().__init__(aug, sparse=True, reader=frame_utils.read_disp_sintel, **kw)
        img1 = sorted(glob(osp.join(root, "training/*_left/*/frame_*.png")))
        img2 = sorted(glob(osp.join(root, "training/*_right/*/frame_*.png")))
        disp = sorted(glob(osp.join(root, "training/disparities/*/frame_*.png"))) * 2
        for l, r, d in zip(img1, img2, disp):
            self.image_list.append([l, r])
            self.disparity_list.append(d)


class FallingThings(StereoDataset):
    def __init__(self, root: str, aug=None, **kw):
        super().__init__(aug, reader=frame_utils.read_disp_falling_things, **kw)
        with open(osp.join(root, "filenames.txt")) as f:
            names = sorted(f.read().splitlines())
        for e in names:
            self.image_list.append(
                [osp.join(root, e), osp.join(root, e.replace("left.jpg", "right.jpg"))]
            )
            self.disparity_list.append(
                osp.join(root, e.replace("left.jpg", "left.depth.png"))
            )


class TartanAir(StereoDataset):
    def __init__(self, root: str, aug=None, keywords=(), **kw):
        super().__init__(aug, reader=frame_utils.read_disp_tartanair, **kw)
        with open(osp.join(root, "tartanair_filenames.txt")) as f:
            names = sorted(
                s for s in f.read().splitlines()
                if "seasonsforest_winter/Easy" not in s
            )
        for kwd in keywords:
            names = [s for s in names if kwd in s.lower()]
        for e in names:
            self.image_list.append(
                [osp.join(root, e), osp.join(root, e.replace("_left", "_right"))]
            )
            self.disparity_list.append(
                osp.join(
                    root,
                    e.replace("image_left", "depth_left").replace(
                        "left.png", "left_depth.npy"
                    ),
                )
            )


# ------------------------------------------------------------------ #


def fetch_dataset(names: Sequence[str], roots: Dict[str, str], aug: AugmentorConfig,
                  **multi_kw) -> StereoDataset:
    """Name → dataset mapping of fetch_dataloader (stereo_datasets.py:487-540),
    including the reference's replication factors (sintel x140, falling x5).
    roots: dataset-name → filesystem root."""
    total = None
    for name in names:
        if name.startswith("middlebury_"):
            ds = Middlebury(roots["middlebury"], aug,
                            split=name.replace("middlebury_", ""), **multi_kw)
        elif name == "sceneflow":
            ds = SceneFlowDataset(roots["sceneflow"], aug, **multi_kw)
        elif "kitti" in name:
            mode = (
                "15_train" if "15only" in name
                else "12_train" if "12only" in name
                else "mix_train_all" if "all" in name
                else "mix_train"
            )
            ds = KittiMixed(roots["kitti12"], roots["kitti15"], aug, mode=mode,
                            **multi_kw)
        elif name == "sintel_stereo":
            ds = SintelStereo(roots["sintel"], aug, **multi_kw) * 140
        elif name == "falling_things":
            ds = FallingThings(roots["falling_things"], aug, **multi_kw) * 5
        elif name.startswith("tartan_air"):
            ds = TartanAir(roots["tartanair"], aug,
                           keywords=name.split("_")[2:], **multi_kw)
        elif name == "eth3d":
            ds = ETH3D(roots["eth3d"], aug, **multi_kw)
        else:
            raise ValueError(f"unknown dataset {name}")
        log.info("added %d samples from %s", len(ds), name)
        total = ds if total is None else total + ds
    return total
