"""The data slice of the PyTorch port vs the JAX package and the decoders it
stands in for: the PNG codec against PIL and OpenCV, the file readers, the
colour conversions and resizes of the augmentor against OpenCV, the seeded
augmentor, the dataset classes on synthetic trees of
`tools/make_synthetic_datasets.py` and the prefetch loader.

Tolerances.  PNG decode, readers, file lists, geometric draws (crops, flips,
scales, query indices), coordinates, valid masks, the gray and HSV
conversions and OpenCV's fixed-point bilinear resize of uint8: exact (for
OpenCV's vector code the HSV round trip and the uint8 resizes are held to 1
level on at most 0.1% of the values, which is what a machine whose vector
unit has another width would give).  uint8 images out of the augmentor and
the datasets: within 1 grey level; OpenCV 5's uint8 bicubic sums in another
order than the port's float32 (measured: 1 level on 0.0-0.05% of pixels).
Float flows and ground truth: 1e-4 px or 1e-4 relative (both sum float32
products of the same taps; measured 2e-7 relative).  The conversions and
resizes held to OpenCV run both the port's C (the default) and its plain
numpy version (`impl`); `tests/test_torch_host_c.py` holds the two to each
other bit for bit.
"""

import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
from PIL import Image  # noqa: E402

from anystereo_tpu.data import augment as jaug  # noqa: E402
from anystereo_tpu.data import datasets as jds  # noqa: E402
from anystereo_tpu.data import frame_utils as jfu  # noqa: E402
from anystereo_tpu.data.loader import PrefetchLoader as JaxLoader  # noqa: E402
from anystereo_tpu_torch.data import augment as taug  # noqa: E402
from anystereo_tpu_torch.data import datasets as tds  # noqa: E402
from anystereo_tpu_torch.data import frame_utils as tfu  # noqa: E402
from anystereo_tpu_torch.data.loader import PrefetchLoader  # noqa: E402
from anystereo_tpu_torch.data.png import read_png, write_png  # noqa: E402
from anystereo_tpu_torch.utils.resize import resize  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import make_synthetic_datasets as synth  # noqa: E402

VECTOR_SHARE = 1e-3  # values allowed 1 level off where OpenCV's vector width matters


def _texture(rng, shape, dtype=np.uint8):
    from scipy.ndimage import gaussian_filter

    x = gaussian_filter(rng.rand(*shape), 1.0)
    x = (x - x.min()) / (x.max() - x.min())
    return (x * np.iinfo(dtype).max).astype(dtype)


# ------------------------------------------------------------------- PNG


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16", "rgb16"])
@pytest.mark.parametrize("impl", ["c", "numpy"])
def test_png_filter_types(tmp_path, filter_type, kind, impl):
    rng = np.random.RandomState(filter_type)
    shape = (23, 37) if kind.startswith("gray") else (23, 37, 3)
    arr = _texture(rng, shape, np.uint8 if kind.endswith("8") else np.uint16)
    p = str(tmp_path / "f.png")
    write_png(p, arr, filter_type=filter_type)
    with open(p, "rb") as f:
        data = f.read()
    raw = zlib.decompress(data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8])
    row = raw[:len(raw) // arr.shape[0]]
    assert row[0] == filter_type  # the file really carries the chosen filter
    got = read_png(p, impl=impl)
    assert got.dtype == arr.dtype and got.shape == arr.shape
    np.testing.assert_array_equal(got, arr)
    if kind == "rgb16":  # PIL keeps the high byte of 16-bit colour; OpenCV all of it
        np.testing.assert_array_equal(got, cv2.imread(p, cv2.IMREAD_UNCHANGED)[..., ::-1])
    else:
        np.testing.assert_array_equal(got, np.array(Image.open(p)))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "I;16"])
def test_png_written_by_pil(tmp_path, mode):
    """PIL chooses each row's filter itself (mostly Paeth)."""
    rng = np.random.RandomState(1)
    channels = {"L": 0, "LA": 2, "RGB": 3, "RGBA": 4, "P": 0, "I;16": 0}[mode]
    shape = (41, 57, channels) if channels else (41, 57)
    if mode == "I;16":
        img = Image.fromarray(_texture(rng, shape, np.uint16))
    else:
        img = Image.fromarray(_texture(rng, shape), mode if mode != "P" else "L")
    if mode == "P":
        img = img.convert("P")
    p = str(tmp_path / "pil.png")
    img.save(p)
    want = np.array(Image.open(p))
    got = read_png(p)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_png_kitti_16bit_written_by_opencv(tmp_path):
    rng = np.random.RandomState(2)
    disp = (rng.rand(375, 124) * 200 * 256).astype(np.uint16)
    disp[rng.rand(*disp.shape) < 0.3] = 0
    p = str(tmp_path / "000000_10.png")
    cv2.imwrite(p, disp)
    np.testing.assert_array_equal(read_png(p), disp)
    np.testing.assert_array_equal(read_png(p), cv2.imread(p, cv2.IMREAD_ANYDEPTH))


@pytest.mark.parametrize("shape,dtype", [((19, 31), np.uint8), ((19, 31, 3), np.uint8),
                                         ((19, 31), np.uint16)])
def test_write_png_round_trips_through_pil(tmp_path, shape, dtype):
    arr = _texture(np.random.RandomState(3), shape, dtype)
    p = str(tmp_path / "w.png")
    write_png(p, arr)
    np.testing.assert_array_equal(np.array(Image.open(p)), arr)


def _set_ihdr(path, **fields):
    """Rewrite IHDR fields (depth, interlace) of a PNG, with its CRC."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    w, h, depth, colour, comp, filt, interlace = struct.unpack(">IIBBBBB", data[16:29])
    depth, interlace = fields.get("depth", depth), fields.get("interlace", interlace)
    data[16:29] = struct.pack(">IIBBBBB", w, h, depth, colour, comp, filt, interlace)
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    with open(path, "wb") as f:
        f.write(bytes(data))


def test_png_refuses_what_it_does_not_decode(tmp_path):
    p = str(tmp_path / "x.png")
    write_png(p, np.zeros((4, 5), np.uint8))
    _set_ihdr(p, interlace=1)
    with pytest.raises(NotImplementedError, match="x.png"):
        read_png(p)
    Image.fromarray(np.zeros((4, 5), bool)).save(p)  # a 1-bit file
    with pytest.raises(NotImplementedError, match="bit depth 1"):
        read_png(p)
    with open(p, "wb") as f:
        f.write(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(p)


# ----------------------------------------------------------------- readers


@pytest.fixture(scope="module")
def reader_files(tmp_path_factory):
    """One file of each kind the readers take, written by the JAX package's
    writers, PIL and OpenCV."""
    d = tmp_path_factory.mktemp("readers")
    rng = np.random.RandomState(4)
    f = {}
    f["pfm"] = str(d / "a.pfm")
    jfu.write_pfm(f["pfm"], rng.rand(13, 17).astype(np.float32) * 50)
    f["pfm_colour"] = str(d / "c.pfm")
    with open(f["pfm_colour"], "wb") as fh:  # a big-endian colour PFM
        fh.write(b"PF\n17 13\n1.0\n")
        fh.write(rng.rand(13, 17, 3).astype(">f4").tobytes())
    f["flo"] = str(d / "a.flo")
    jfu.write_flo(f["flo"], rng.rand(9, 11, 2).astype(np.float32))
    f["png"] = str(d / "img.png")
    Image.fromarray(_texture(rng, (21, 33, 3))).save(f["png"])
    f["ppm"] = str(d / "img.ppm")
    Image.fromarray(_texture(rng, (21, 33, 3))).save(f["ppm"])
    f["jpg"] = str(d / "img.jpg")
    Image.fromarray(_texture(rng, (21, 33, 3))).save(f["jpg"])
    kitti = (rng.rand(20, 30) * 100 * 256).astype(np.uint16)
    kitti[::4] = 0
    f["kitti"] = str(d / "disp_occ_0" / "000000_10.png")
    os.makedirs(os.path.dirname(f["kitti"]))
    cv2.imwrite(f["kitti"], kitti)
    f["sintel"] = str(d / "disparities" / "alley_1" / "frame_0001.png")
    for sub, img in (("disparities", _texture(rng, (12, 16, 3))),
                     ("occlusions", (rng.rand(12, 16) > 0.8).astype(np.uint8) * 255)):
        path = f["sintel"].replace("disparities", sub)
        os.makedirs(os.path.dirname(path))
        Image.fromarray(img).save(path)
    f["falling"] = str(d / "ft" / "0000.left.depth.png")
    os.makedirs(os.path.dirname(f["falling"]))
    Image.fromarray((rng.rand(12, 16) * 6000 + 100).astype(np.uint16)).save(f["falling"])
    with open(os.path.join(os.path.dirname(f["falling"]), "_camera_settings.json"), "w") as fh:
        json.dump({"camera_settings": [{"intrinsic_settings": {"fx": 768.16}}]}, fh)
    f["tartan"] = str(d / "000000_left_depth.npy")
    np.save(f["tartan"], (rng.rand(12, 16) * 30 + 1).astype(np.float32))
    f["midd"] = str(d / "midd" / "disp0GT.pfm")
    os.makedirs(os.path.dirname(f["midd"]))
    jfu.write_pfm(f["midd"], rng.rand(12, 16).astype(np.float32) * 40)
    Image.fromarray(np.where(rng.rand(12, 16) > 0.2, 255, 128).astype(np.uint8)).save(
        f["midd"].replace("disp0GT.pfm", "mask0nocc.png"))
    f["midd14"] = str(d / "midd14" / "disp0.pfm")
    os.makedirs(os.path.dirname(f["midd14"]))
    gt = rng.rand(12, 16).astype(np.float32) * 40
    gt[0] = np.inf
    jfu.write_pfm(f["midd14"], gt)
    return f


READERS = {
    "read_pfm": ("read_pfm", "pfm"),
    "read_pfm_colour": ("read_pfm", "pfm_colour"),
    "read_flo": ("read_flo", "flo"),
    "read_gen_png": ("read_gen", "png"),
    "read_gen_ppm": ("read_gen", "ppm"),
    "read_gen_jpg": ("read_gen", "jpg"),
    "read_gen_pfm": ("read_gen", "pfm"),
    "read_gen_pfm_colour": ("read_gen", "pfm_colour"),
    "read_gen_flo": ("read_gen", "flo"),
    "read_disp_kitti": ("read_disp_kitti", "kitti"),
    "read_disp_sintel": ("read_disp_sintel", "sintel"),
    "read_disp_falling_things": ("read_disp_falling_things", "falling"),
    "read_disp_tartanair": ("read_disp_tartanair", "tartan"),
    "read_disp_middlebury": ("read_disp_middlebury", "midd"),
    "read_disp_middlebury_2014": ("read_disp_middlebury", "midd14"),
}


@pytest.mark.parametrize("case", list(READERS))
def test_reader_matches_jax(reader_files, case):
    fn, key = READERS[case]
    want = getattr(jfu, fn)(reader_files[key])
    got = getattr(tfu, fn)(reader_files[key])
    want, got = (w if isinstance(w, tuple) else (w,) for w in (want, got))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_pfm_and_flo_writers_round_trip(tmp_path):
    rng = np.random.RandomState(5)
    a = rng.rand(7, 9).astype(np.float32)
    tfu.write_pfm(str(tmp_path / "a.pfm"), a)
    np.testing.assert_array_equal(jfu.read_pfm(str(tmp_path / "a.pfm")), a)
    uv = rng.rand(7, 9, 2).astype(np.float32)
    tfu.write_flo(str(tmp_path / "a.flo"), uv)
    np.testing.assert_array_equal(jfu.read_flo(str(tmp_path / "a.flo")), uv)


def test_jpeg_without_pil(reader_files, monkeypatch):
    """With PIL masked, the port still reads the JPEG to the array the JAX
    reader (PIL) gives: its decoder is its own C."""
    want = jfu.read_gen(reader_files["jpg"])
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = tfu.read_gen(reader_files["jpg"])
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- colour and resize


def _all_colours():
    c = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij"), -1)
    return c.reshape(4096, 4096, 3).astype(np.uint8)


IMPLS = ["c", "numpy"]  # the port's C (the default) and its plain numpy version


@pytest.mark.parametrize("impl", IMPLS)
def test_rgb_to_gray_exact_on_every_colour(impl):
    c = _all_colours()
    np.testing.assert_array_equal(taug.rgb_to_gray(c, impl=impl), cv2.cvtColor(c, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("impl", IMPLS)
def test_rgb_to_hsv_exact_on_every_colour(impl):
    c = _all_colours()
    np.testing.assert_array_equal(taug.rgb_to_hsv(c, impl=impl), cv2.cvtColor(c, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("width", [4096, 376, 97, 31])
def test_hsv_round_trip(width, impl):
    c = _all_colours().reshape(-1, width, 3) if 4096 * 4096 % width == 0 else \
        np.random.RandomState(width).randint(0, 256, (997, width, 3)).astype(np.uint8)
    want = cv2.cvtColor(cv2.cvtColor(c, cv2.COLOR_RGB2HSV), cv2.COLOR_HSV2RGB)
    got = taug.hsv_to_rgb(taug.rgb_to_hsv(c, impl=impl), impl=impl)
    diff = np.abs(got.astype(int) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= VECTOR_SHARE, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("scale", [(1.3, 1.17), (0.93, 1.6), (1.9, 0.77), (0.5, 0.5)])
@pytest.mark.parametrize("mode", ["linear", "cubic"])
def test_resize_uint8_by_scale(scale, mode, impl):
    img = _texture(np.random.RandomState(6), (61, 103, 3))
    flag = cv2.INTER_LINEAR if mode == "linear" else cv2.INTER_CUBIC
    want = cv2.resize(img, None, fx=scale[0], fy=scale[1], interpolation=flag)
    got = resize(img, None, mode, scale=scale, impl=impl)
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= VECTOR_SHARE, (diff.max(), (diff > 0).mean())
    flow = img[..., :2].astype(np.float32) * 0.37
    want = cv2.resize(flow, None, fx=scale[0], fy=scale[1], interpolation=flag)
    np.testing.assert_allclose(resize(flow, None, mode, scale=scale, impl=impl), want, rtol=0, atol=1e-4)


# -------------------------------------------------------------- augmentor


AUG_CASES = {
    "dense": (dict(crop_size=(48, 80), yjitter=True), False, None, None),
    "dense_flip_h": (dict(crop_size=(48, 80), do_flip="h"), False, None, None),
    "dense_flip_hf": (dict(crop_size=(48, 80), do_flip="hf", h_flip_prob=1.0), False, None, None),
    "dense_flip_v": (dict(crop_size=(48, 80), do_flip="v", v_flip_prob=1.0), False, None, None),
    "dense_gamma": (dict(crop_size=(48, 80), gamma=(0.8, 1.2, 0.9, 1.1)), False, None, None),
    "dense_multiscale": (dict(), False, (70, 140), (40, 80)),
    "sparse": (dict(crop_size=(48, 80)), True, None, None),
    "sparse_multiscale": (dict(), True, (70, 140), (40, 80)),
}


def _images_close(got, want, what, exact):
    """Images through OpenCV's arithmetic: equal where no uint8 bicubic made
    them (`exact`), else 1 level off on at most VECTOR_SHARE of the values
    (OpenCV 5's uint8 bicubic sums in another order)."""
    diff = np.abs(np.asarray(got).astype(int) - np.asarray(want))
    share = (diff > 0).mean()
    assert diff.max() <= (0 if exact else 1) and share <= VECTOR_SHARE, (what, diff.max(), share)
    return share


@pytest.mark.parametrize("case", list(AUG_CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augmentor_matches_jax(case, seed):
    kw, sparse, crop, scale_size = AUG_CASES[case]
    rng = np.random.RandomState(10 + seed)
    img1, img2 = _texture(rng, (96, 160, 3)), _texture(rng, (96, 160, 3))
    flow = np.stack([rng.rand(96, 160).astype(np.float32) * 30, np.zeros((96, 160), np.float32)], -1)
    valid = (rng.rand(96, 160) > 0.4).astype(np.float32) if sparse else None
    if sparse:
        flow[..., 0] *= valid
    args = (img1, img2, flow) + ((valid,) if sparse else ())
    outs, states = [], []
    for mod in (jaug, taug):
        r = np.random.RandomState(seed)
        outs.append(mod.StereoAugmentor(mod.AugmentorConfig(**kw), sparse=sparse)(
            *args, crop_size=crop, scale_size=scale_size, rng=r))
        states.append(r.get_state()[1])
    np.testing.assert_array_equal(states[0], states[1])  # every draw made, in order
    want, got = outs
    assert len(got) == len(want) and all(g.shape == w.shape for g, w in zip(got, want))
    share = max(_images_close(got[i], want[i], i, exact=scale_size is None) for i in (0, 1))
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-4)
    if sparse:
        np.testing.assert_array_equal(got[3], want[3])
    print(f"{case} seed {seed}: {share:.2e} of image values 1 level apart")


# --------------------------------------------------------------- datasets


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The synthetic SceneFlow, KITTI 2012/2015, Middlebury and ETH3D trees,
    plus Sintel, FallingThings and TartanAir trees of a few frames."""
    root = str(tmp_path_factory.mktemp("synth"))
    rng = np.random.RandomState(0)
    synth.gen_sceneflow(root, rng, n_train=3, n_test=3, h=96, w=160)
    synth.gen_kitti15(root, rng, n=3, h=64, w=160)
    synth.gen_kitti12(root, rng, n=3, h=64, w=160)
    synth.gen_middlebury(root, rng, hf=64, wf=96)
    synth.gen_eth3d(root, rng, h=48, w=80)
    for i in range(2):
        for sub in ("clean_left", "clean_right", "disparities", "occlusions"):
            p = os.path.join(root, "sintel", "training", sub, "alley_1", f"frame_{i:04d}.png")
            os.makedirs(os.path.dirname(p), exist_ok=True)
            img = _texture(rng, (48, 80, 3)) if sub != "occlusions" else \
                ((rng.rand(48, 80) > 0.9) * 255).astype(np.uint8)
            Image.fromarray(img).save(p)
    ft = os.path.join(root, "falling", "kitchen_0")
    os.makedirs(ft)
    with open(os.path.join(ft, "_camera_settings.json"), "w") as fh:
        json.dump({"camera_settings": [{"intrinsic_settings": {"fx": 768.16}}]}, fh)
    names = []
    for i in range(2):
        for view in ("left", "right"):
            Image.fromarray(_texture(rng, (48, 80, 3))).save(os.path.join(ft, f"{i:06d}.{view}.jpg"))
        Image.fromarray((rng.rand(48, 80) * 3000 + 4000).astype(np.uint16)).save(
            os.path.join(ft, f"{i:06d}.left.depth.png"))
        names.append(f"kitchen_0/{i:06d}.left.jpg")
    with open(os.path.join(root, "falling", "filenames.txt"), "w") as fh:
        fh.write("\n".join(names[::-1]))
    tnames = []
    for env in ("abandonedfactory", "seasonsforest_winter"):
        base = os.path.join(root, "tartan", env, "Easy", "P000")
        for sub in ("image_left", "image_right", "depth_left"):
            os.makedirs(os.path.join(base, sub))
        Image.fromarray(_texture(rng, (48, 80, 3))).save(os.path.join(base, "image_left", "000000_left.png"))
        Image.fromarray(_texture(rng, (48, 80, 3))).save(os.path.join(base, "image_right", "000000_right.png"))
        np.save(os.path.join(base, "depth_left", "000000_left_depth.npy"),
                (rng.rand(48, 80) * 20 + 2).astype(np.float32))
        tnames.append(f"{env}/Easy/P000/image_left/000000_left.png")
    with open(os.path.join(root, "tartan", "tartanair_filenames.txt"), "w") as fh:
        fh.write("\n".join(tnames))
    return root


def _pair_of(tree, name):
    """(JAX dataset, the port's) of one class, built alike, with no augmentor."""
    j = os.path.join
    build = {
        "sceneflow_train": lambda m: m.SceneFlowDataset(tree),
        "sceneflow_test": lambda m: m.SceneFlowDataset(tree, things_test=True),
        "kitti15": lambda m: m.KittiDataset(tree, year=2015),
        "kitti12": lambda m: m.KittiDataset(tree, year=2012),
        "kitti15_testing": lambda m: m.KittiDataset(tree, image_set="training", year=2015) * 2,
        "middlebury_F": lambda m: m.Middlebury(tree, split="F"),
        "middlebury_Q": lambda m: m.Middlebury(tree, split="Q"),
        "eth3d": lambda m: m.ETH3D(tree),
        "eth3d_test": lambda m: m.ETH3D(tree, split="test"),
        "sintel": lambda m: m.SintelStereo(j(tree, "sintel")),
        "falling_things": lambda m: m.FallingThings(j(tree, "falling")),
        "tartan_air": lambda m: m.TartanAir(j(tree, "tartan")),
        "tartan_air_factory": lambda m: m.TartanAir(j(tree, "tartan"), keywords=("factory",)),
    }
    if name.startswith("kitti_mixed_"):
        mode = name[len("kitti_mixed_"):]
        return tuple(m.KittiMixed(tree, tree, mode=mode) for m in (jds, tds))
    return build[name](jds), build[name](tds)


DATASETS = ["sceneflow_train", "sceneflow_test", "kitti15", "kitti12", "kitti15_testing",
            "middlebury_F", "middlebury_Q", "eth3d", "eth3d_test", "sintel", "falling_things",
            "tartan_air", "tartan_air_factory"] + [
    f"kitti_mixed_{m}" for m in ("mix_train", "mix_train_all", "valid_12", "valid_15", "12_train",
                                 "15_train")]


@pytest.mark.parametrize("name", DATASETS)
def test_dataset_lists_and_raw_frames_match_jax(tree, name):
    jd, td = _pair_of(tree, name)
    assert td.image_list == jd.image_list and td.disparity_list == jd.disparity_list
    # with three KITTI frames a year the seed-1000 held-out split takes them
    # all, and the ETH3D tree has no test split
    assert len(td) == len(jd) and (len(td) > 0) == (name not in ("eth3d_test", "kitti_mixed_mix_train"))
    for i in range(min(len(td), 2)):
        for g, w in zip(td._load_raw(i), jd._load_raw(i)):
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_fetch_dataset_names_match_jax(tree):
    roots = {"sceneflow": tree, "kitti12": tree, "kitti15": tree, "middlebury": tree,
             "eth3d": tree, "sintel": os.path.join(tree, "sintel"),
             "falling_things": os.path.join(tree, "falling"), "tartanair": os.path.join(tree, "tartan")}
    names = ["sceneflow", "kitti", "kitti_15only", "kitti_12only", "kitti_all", "middlebury_F",
             "sintel_stereo", "falling_things", "tartan_air_factory", "eth3d"]
    for name in names:
        want = jds.fetch_dataset([name], roots, jaug.AugmentorConfig())
        got = tds.fetch_dataset([name], roots, taug.AugmentorConfig())
        assert got.image_list == want.image_list and got.disparity_list == want.disparity_list, name
    with pytest.raises(ValueError):
        tds.fetch_dataset(["nope"], roots, taug.AugmentorConfig())


def test_fetch_dataset_mix_reads_each_sample_with_its_own_reader(tree):
    """A mix of datasets makes each sample with the dataset it came from, as
    the reference's `a + b` (`ConcatDataset`) does: FallingThings' samples
    of ["sceneflow", "falling_things"] take their disparity from the depth
    PNG through FallingThings' reader (fx * 600 / depth).  The JAX package's
    mix reads them with SceneFlow's `read_gen`, which gives the raw depth;
    the port does not copy that fault."""
    roots = {"sceneflow": tree, "falling_things": os.path.join(tree, "falling")}
    mix = tds.fetch_dataset(["sceneflow", "falling_things"], roots, taug.AugmentorConfig())
    jmix = jds.fetch_dataset(["sceneflow", "falling_things"], roots, jaug.AugmentorConfig())
    assert mix.image_list == jmix.image_list and mix.disparity_list == jmix.disparity_list
    n_sf, ft = len(jds.SceneFlowDataset(tree)), jds.FallingThings(roots["falling_things"])
    assert len(mix) == len(jmix) == n_sf + 5 * len(ft) and len(ft) > 0
    for i, (want, j) in {0: (jds.SceneFlowDataset(tree), 0), n_sf: (ft, 0),
                         len(mix) - 1: (ft, len(ft) - 1)}.items():
        for g, w in zip(mix._load_raw(i), want._load_raw(j)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert not np.array_equal(jmix._load_raw(n_sf)[2], ft._load_raw(0)[2])  # the JAX mix's fault
    own = tds.FallingThings(roots["falling_things"], taug.AugmentorConfig())
    got = mix.__getitem__(n_sf, rng=np.random.RandomState(3))
    want = own.__getitem__(0, rng=np.random.RandomState(3))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


SAMPLE_MODES = {
    "standard": dict(),
    "multi_scale": dict(multi_scale=True, scale_min=1.0, scale_max=1.6, inp_size=(32, 64)),
    "multi_scale_fixed": dict(multi_scale=True, scale_min=1.5, scale_max=1.5, inp_size=(32, 64)),
    "multi_input": dict(multi_input=True, scale_min=1.0, scale_max=1.8),
}


@pytest.mark.parametrize("mode", list(SAMPLE_MODES))
@pytest.mark.parametrize("data", ["sceneflow", "kitti"])
def test_dataset_samples_match_jax(tree, mode, data):
    kw = SAMPLE_MODES[mode]
    aug = dict(crop_size=(40, 72), yjitter=True, min_scale=-0.2, max_scale=0.4)
    if data == "sceneflow":
        jd, td = (m.SceneFlowDataset(tree, a.AugmentorConfig(**aug), **kw)
                  for m, a in ((jds, jaug), (tds, taug)))
    else:
        jd, td = (m.KittiMixed(tree, tree, a.AugmentorConfig(**aug), mode="mix_train_all", **kw)
                  for m, a in ((jds, jaug), (tds, taug)))
    for i in range(2):
        want = jd.__getitem__(i, rng=np.random.RandomState(20 + i))
        got = td.__getitem__(i, rng=np.random.RandomState(20 + i))
        assert set(got) == set(want)
        for k in want:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.shape == w.shape and g.dtype == w.dtype, k
            if k in ("left", "right"):  # only the standard mode has no bicubic step
                _images_close(g, w, k, exact=mode == "standard")
            elif k in ("gt", "gt_low", "disp"):
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=k)
            else:  # coords, scale, valid: the draws themselves
                np.testing.assert_array_equal(g, w, err_msg=k)


def test_make_coord_np_matches_jax():
    for shape in ((5, 7), (32, 64), (3,)):
        np.testing.assert_array_equal(tds.make_coord_np(shape), jds.make_coord_np(shape))


# ------------------------------------------------------------------ loader


@pytest.mark.parametrize("hosts", [(0, 1), (0, 2), (1, 2)])
def test_prefetch_loader_matches_jax(tree, hosts):
    kw = dict(multi_scale=True, scale_min=1.0, scale_max=1.6, inp_size=(32, 64))
    jd = jds.SceneFlowDataset(tree, jaug.AugmentorConfig(yjitter=True), **kw)
    td = tds.SceneFlowDataset(tree, taug.AugmentorConfig(yjitter=True), **kw)
    jd, td = jd * 2, td * 2  # 6 training frames, 12 samples an epoch
    want_it = iter(JaxLoader(jd, 2, num_workers=2, seed=7, host_index=hosts[0], host_count=hosts[1]))
    loader = PrefetchLoader(td, 2, num_workers=3, seed=7, host_index=hosts[0], host_count=hosts[1])
    got_it = iter(loader)
    n = len(loader) + 1  # into the second epoch
    for _ in range(n):
        want, got = next(want_it), next(got_it)
        assert set(got) == set(want)
        for k in want:
            if k in ("left", "right"):
                _images_close(got[k], want[k], k, exact=False)  # multi-scale: bicubic
            elif k in ("gt", "gt_low"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6)
            else:
                np.testing.assert_array_equal(got[k], want[k])
    want_it.close()
    got_it.close()


def test_prefetch_loader_raises_what_a_sample_raises(tree):
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i, rng=None):
            raise ValueError(f"cannot decode sample {i}")

    it = iter(PrefetchLoader(Broken(), 2, num_workers=2, seed=0))
    with pytest.raises(ValueError, match="cannot decode"):
        next(it)
    it.close()


# ----------------------------------------------------------------- imports


def test_the_port_imports_no_jax_opencv_or_pil():
    """Every module of the port, imported in a fresh interpreter, loads none
    of the JAX stack, grain, OpenCV, PIL or the JAX package."""
    import pkgutil
    import subprocess

    import anystereo_tpu_torch

    root = os.path.dirname(os.path.abspath(list(anystereo_tpu_torch.__path__)[0]))
    names = [m.name for m in pkgutil.walk_packages(anystereo_tpu_torch.__path__, "anystereo_tpu_torch.")]
    assert {"anystereo_tpu_torch.data.png", "anystereo_tpu_torch.train.trainer",
            "anystereo_tpu_torch.eval.reporting", "anystereo_tpu_torch.data.grain_loader",
            "anystereo_tpu_torch.data.index_shuffle"} <= set(names)
    assert {f"anystereo_tpu_torch.tools.{t}" for t in (
        "make_synthetic_datasets", "e2e_demo", "overfit_sanity", "check_datasets", "reproduce_baseline",
        "scaling_bench")} <= set(names)
    code = ("import importlib, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "bad = [m for m in ('jax', 'flax', 'optax', 'grain', 'cv2', 'PIL', 'anystereo_tpu') "
            "if m in sys.modules]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0, out.stderr[-2000:]
