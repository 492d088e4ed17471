"""The data recipe of the port's tools (`anystereo_tpu_torch/tools/`) against
the repo's JAX tools (`tools/`), which write with OpenCV and PIL, on the CPU
with the same `np.random.RandomState` seeds.

Bands.  The port redoes OpenCV's float32 Gaussian blur as two scipy passes
whose sums run in another order (1.8e-7 of a unit texture), so a uint8 view
truncated from it is one level off on a few pixels: the left view on at most
1e-4 of them (measured 0-2.2e-5).  OpenCV 5's linear remap is v0 + (v1 - v0)
f with one rounding, which the port computes bit for bit; the right view's
extra levels come from the disparity field (within 1.1e-4 px), which moves
the sampling positions: at most RIGHT_SHARE (measured 1.3e-4 to 3.7e-4).
Disparity within 2e-4 px.  Area resizes at 2x and 4x, the 16-bit KITTI
PNGs and the PFMs: exact.

The tree writer and the dataset gate also run here as tools, in a
subprocess with cv2 and PIL blocked (`test_torch_tools_train._tool`), and
without `--device` every tool wants the CUDA card and raises.
"""

import importlib
import importlib.util
import os
import re
import shutil

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
from PIL import Image  # noqa: E402

from anystereo_tpu.data import datasets as jds  # noqa: E402
from anystereo_tpu.data.augment import AugmentorConfig as JaxAugmentorConfig  # noqa: E402
from anystereo_tpu.eval.validate import build_eval_dataset as jax_build_eval_dataset  # noqa: E402
from anystereo_tpu_torch.data import datasets as tds  # noqa: E402
from anystereo_tpu_torch.data.augment import AugmentorConfig  # noqa: E402
from anystereo_tpu_torch.data.frame_utils import read_disp_kitti, read_pfm  # noqa: E402
from anystereo_tpu_torch.data.png import read_png  # noqa: E402
from anystereo_tpu_torch.eval.validate import build_eval_dataset  # noqa: E402
from anystereo_tpu_torch.tools import e2e_demo, make_synthetic_datasets as synth  # noqa: E402
from anystereo_tpu_torch.tools import overfit_sanity  # noqa: E402
from anystereo_tpu_torch.tools.check_datasets import EVAL_SPECS  # noqa: E402
from test_torch_tools_train import _tool  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEFT_SHARE = 1e-4
RIGHT_SHARE = 5e-4
DISP_ATOL = 2e-4
TOOLS = ("make_synthetic_datasets", "e2e_demo", "overfit_sanity", "check_datasets", "reproduce_baseline",
         "scaling_bench")


def _jax_tool(name):
    """The repo's `tools/<name>.py`, loaded under a name of its own."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_synth():
    return _jax_tool("make_synthetic_datasets")


def _within_one_level(got, want, share, what):
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert got.shape == want.shape and got.dtype == want.dtype, what
    assert diff.max() <= 1, (what, diff.max())
    assert (diff > 0).mean() <= share, (what, (diff > 0).mean())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("hw", [(200, 400), (120, 376)])
def test_make_pair_matches_the_jax_tool(jax_synth, hw, seed):
    jl, jr, jd = jax_synth.make_pair(np.random.RandomState(seed), *hw)
    left, right, disp = synth.make_pair(np.random.RandomState(seed), *hw)
    _within_one_level(left, jl, LEFT_SHARE, "left")
    _within_one_level(right, jr, RIGHT_SHARE, "right")
    assert disp.dtype == jd.dtype and np.abs(disp - jd).max() <= DISP_ATOL


@pytest.mark.parametrize("sigma", [1.2, 1.5, 12.0])
def test_gaussian_blur_matches_opencv(sigma):
    a = np.random.RandomState(3).rand(40, 120, 3).astype(np.float32)
    for x in (a, a[..., 0]):
        np.testing.assert_allclose(synth.gaussian_blur(x, sigma), cv2.GaussianBlur(x, (0, 0), sigma),
                                   rtol=0, atol=1e-6)


def test_remap_x_is_opencv_remap_bit_for_bit():
    rng = np.random.RandomState(4)
    src = (rng.rand(30, 90) * 255).astype(np.float32)
    xs = (rng.rand(30, 70) * 89).astype(np.float32)
    xs[0, :3] = (0.0, 89.0, 17.0)
    ys = np.tile(np.arange(30, dtype=np.float32)[:, None], (1, 70))
    np.testing.assert_array_equal(synth.remap_x(src, xs), cv2.remap(src, xs, ys, cv2.INTER_LINEAR))
    with pytest.raises(ValueError):
        synth.remap_x(src, xs + 1)


@pytest.mark.parametrize("s", [1, 2, 4])
def test_area_downsample_is_opencv_inter_area(s):
    rng = np.random.RandomState(s)
    for a in ((rng.rand(96, 128, 3) * 255).astype(np.uint8), (rng.rand(96, 128) * 255).astype(np.uint8),
              (rng.rand(96, 128) * 30).astype(np.float32)):
        want = cv2.resize(a, (128 // s, 96 // s), interpolation=cv2.INTER_AREA)
        got = synth.area_downsample(a, s)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_middlebury_splits_are_opencv_area_resizes_of_the_ports_pair(tmp_path):
    """F/H/Q images and ground truth: `cv2.resize(INTER_AREA)` of the port's
    own full-resolution pair, bit for bit, with the missing-GT band and the
    occlusion mask."""
    synth.gen_middlebury(str(tmp_path), np.random.RandomState(5))
    rng = np.random.RandomState(5)
    for scene in ("scene_a", "scene_b"):
        lf, rf, df = synth.make_pair(rng, 192, 256, dmax=20.0)
        for split, s in (("F", 1), ("H", 2), ("Q", 4)):
            h, w = 192 // s, 256 // s
            base = tmp_path / "MiddEval3" / f"training{split}" / scene
            for name, img in (("im0.png", lf), ("im1.png", rf)):
                np.testing.assert_array_equal(read_png(str(base / name)),
                                              cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA))
            gt = cv2.resize(df, (w, h), interpolation=cv2.INTER_AREA) / s
            gt[: h // 10] = np.inf
            np.testing.assert_array_equal(read_pfm(str(base / "disp0GT.pfm")), gt)
            nocc = read_png(str(base / "mask0nocc.png"))
            assert nocc.shape == (h, w) and (nocc[:, : w // 6] == 128).all() and (nocc[:, w // 6:] == 255).all()


def test_kitti_pngs_and_pfms_read_back_exactly(tmp_path):
    """KITTI's 16-bit disparity PNGs (disp * 256 as uint16) and every PFM
    read back through the port's readers as written."""
    root = str(tmp_path)
    synth.gen_sceneflow(root, np.random.RandomState(6), n_train=1, n_test=1, h=48, w=96)
    synth.gen_kitti15(root, np.random.RandomState(7), n=2, h=40, w=96)
    synth.gen_kitti12(root, np.random.RandomState(8), n=1, h=40, w=96)
    rng = np.random.RandomState(6)
    for split in ("TRAIN", "TEST"):
        left, right, disp = synth.make_pair(rng, 48, 96)
        base = tmp_path / "frames_finalpass" / split / "A" / "0000"
        np.testing.assert_array_equal(read_png(str(base / "left" / "0000.png")), left)
        np.testing.assert_array_equal(read_png(str(base / "right" / "0000.png")), right)
        np.testing.assert_array_equal(
            read_pfm(str(tmp_path / "disparity" / split / "A" / "0000" / "left" / "0000.pfm")), disp)
    for seed, n, (im_l, im_r, occ_dir, noc_dir) in (
            (7, 2, ("image_2", "image_3", "disp_occ_0", "disp_noc_0")),
            (8, 1, ("colored_0", "colored_1", "disp_occ", "disp_noc"))):
        rng = np.random.RandomState(seed)
        for i in range(n):
            left, right, disp = synth.make_pair(rng, 40, 96)
            occ = disp.copy()
            occ[rng.rand(40, 96) < 0.3] = 0
            noc = occ.copy()
            noc[:, : 96 // 8] = 0
            name = f"{i:06d}_10.png"
            train = tmp_path / "training"
            np.testing.assert_array_equal(read_png(str(train / im_l / name)), left)
            np.testing.assert_array_equal(read_png(str(train / im_r / name)), right)
            for sub, d in ((occ_dir, occ), (noc_dir, noc)):
                raw = read_png(str(train / sub / name))
                assert raw.dtype == np.uint16
                np.testing.assert_array_equal(raw, (d * 256.0).astype(np.uint16))
                np.testing.assert_array_equal(cv2.imread(str(train / sub / name), cv2.IMREAD_UNCHANGED), raw)
                got, valid = read_disp_kitti(str(train / sub / name))
                np.testing.assert_array_equal(got, (d * 256.0).astype(np.uint16).astype(np.float32) / 256.0)
                np.testing.assert_array_equal(valid, got > 0)


@pytest.fixture(scope="module")
def trees(tmp_path_factory, jax_synth):
    """The JAX tool's tree and the port's, both `generate_all(seed=0,
    sceneflow_n=2)`."""
    jax_root = str(tmp_path_factory.mktemp("jax_tree"))
    port_root = str(tmp_path_factory.mktemp("port_tree"))
    jax_synth.generate_all(jax_root, 0, 2)
    synth.generate_all(port_root, 0, 2)
    return jax_root, port_root


def _relative(paths, root):
    return [os.path.relpath(p, root) for p in paths]


@pytest.mark.parametrize("key", synth.PROTOCOLS)
def test_every_protocol_reads_the_ports_tree_as_jax_reads_its_own(trees, key):
    jax_root, port_root = trees
    jds_, jfix, _, jvalid = jax_build_eval_dataset(key, jax_root)
    ds, fix, _, valid = build_eval_dataset(key, port_root, "cpu")
    assert len(ds) == len(jds_) > 0
    assert (fix, valid) == (jfix, jvalid)
    assert [_relative(p, port_root) for p in ds.image_list] == [_relative(p, jax_root) for p in jds_.image_list]
    assert _relative(ds.disparity_list, port_root) == _relative(jds_.disparity_list, jax_root)
    l, r, flow, v = ds._load_raw(0)
    jl, jr, jflow, jv = jds_._load_raw(0)
    assert l.shape == jl.shape and flow.shape == jflow.shape
    np.testing.assert_array_equal(np.isfinite(flow), np.isfinite(jflow))
    np.testing.assert_array_equal(np.asarray(v, bool), np.asarray(jv, bool))


@pytest.mark.parametrize("mode", ["mix_train", "mix_train_all", "valid_12", "valid_15", "12_train", "15_train"])
def test_kitti_mixed_and_fetch_dataset_count_as_jax(trees, mode):
    jax_root, port_root = trees
    assert len(tds.KittiMixed(port_root, port_root, aug=None, mode=mode)) == \
        len(jds.KittiMixed(jax_root, jax_root, aug=None, mode=mode))
    kw = dict(multi_scale=True, scale_min=1.0, scale_max=2.95, inp_size=(160, 320))
    names = ["sceneflow", "kitti_all"] if mode == "mix_train_all" else ["sceneflow"]
    roots = {k: port_root for k in ("sceneflow", "kitti12", "kitti15")}
    ds = tds.fetch_dataset(names, roots, AugmentorConfig(crop_size=(160, 320)), **kw)
    jroots = {k: jax_root for k in roots}
    jds_ = jds.fetch_dataset(names, jroots, JaxAugmentorConfig(crop_size=(160, 320)), **kw)
    assert len(ds) == len(jds_) > 0


def test_e2e_make_dataset_matches_the_jax_tool(tmp_path):
    """The files of `e2e_demo.make_dataset` against the JAX tool's
    (`tools/e2e_demo.py:22-56`), at this module's bands."""
    jax_e2e = _jax_tool("e2e_demo")
    n = 3
    jax_e2e.make_dataset(str(tmp_path / "jax"), n)
    e2e_demo.make_dataset(str(tmp_path / "port"), n)
    for i in range(n):
        for kind, share in (("l", LEFT_SHARE), ("r", RIGHT_SHARE)):
            want = np.asarray(Image.open(tmp_path / "jax" / f"{kind}{i:03d}.png"))
            _within_one_level(read_png(str(tmp_path / "port" / f"{kind}{i:03d}.png")), want, share, f"{kind}{i}")
        got, want = (read_pfm(str(tmp_path / d / f"d{i:03d}.pfm")) for d in ("port", "jax"))
        assert np.abs(got - want).max() <= DISP_ATOL
    ds = e2e_demo.build(str(tmp_path / "port"), n, multi_scale=True, inp_size=(64, 128))
    sample = ds.__getitem__(0, np.random.RandomState(0))
    assert sample["left"].shape == (64, 128, 3) and sample["coords"].shape == (64 * 128, 2)


def test_overfit_batch_matches_the_jax_script():
    """`overfit_sanity.make_batch()` against `tools/overfit_sanity.py:14-38`
    (which trains at import), written out here with OpenCV's blur."""
    d_true, b, h, w, q = 6.0, 2, 64, 128, 1024
    rng = np.random.RandomState(0)

    def make_pair():
        tex = rng.rand(h, w + 32, 3).astype(np.float32)
        tex = cv2.GaussianBlur(tex, (0, 0), 1.5) * 255
        return tex[:, 32:], tex[:, 32 - int(d_true):w + 32 - int(d_true)]

    pairs = [make_pair() for _ in range(b)]
    want = {
        "left": np.stack([p[0] for p in pairs]), "right": np.stack([p[1] for p in pairs]),
        "coords": (rng.rand(b, q, 2).astype(np.float32) * 2 - 1) * 0.95,
        "gt": np.full((b, q), d_true, np.float32), "valid": np.ones((b, q), np.float32),
        "scale": np.ones((b,), np.float32), "gt_low": np.full((b, h // 4, w // 4), d_true / 4.0, np.float32),
    }
    got = overfit_sanity.make_batch()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if k in ("left", "right"):  # the blur's float sums: 1.8e-7 of a unit texture, x 255
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-4)
        else:
            np.testing.assert_array_equal(got[k], v)


def test_the_trees_are_the_ones_the_jax_tool_writes(trees):
    """Every file the JAX tool writes, the port writes under the same name."""
    jax_root, port_root = trees

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)

    assert files(port_root) == files(jax_root)


# ------------------------------------------------ the tree writer and the dataset gate, run as tools


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthetic"))
    synth.generate_all(root, 0, sceneflow_n=1)
    return root


@pytest.mark.parametrize("name", TOOLS)
def test_each_tool_wants_the_card_by_default(tmp_path, name):
    required = {"make_synthetic_datasets": ["--out", tmp_path / "out"],
                "check_datasets": ["--data-root", tmp_path],
                "reproduce_baseline": ["--data-root", tmp_path, "--ckpt", tmp_path / "ckpt"],
                "e2e_demo": ["--out", tmp_path / "out"]}.get(name, [])
    tool = importlib.import_module(f"anystereo_tpu_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tool.main([str(a) for a in required])
    assert not os.path.exists(tmp_path / "out")


def test_make_synthetic_datasets_main(tmp_path):
    out = _tool("make_synthetic_datasets", "--out", tmp_path, "--sceneflow-n", 1, "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    counts = dict(re.findall(r"^(\w+)\s+(\d+) images$", out.stdout, re.M))
    assert set(counts) == set(synth.PROTOCOLS) and all(int(v) > 0 for v in counts.values()), out.stdout


@pytest.mark.parametrize("case", ["missing_root", "synthetic_tree", "truncated_png"])
def test_check_datasets(tmp_path, tree, case):
    root = tree
    if case == "missing_root":
        root = tmp_path / "absent"
    elif case == "truncated_png":
        root = str(tmp_path / "tree")
        shutil.copytree(tree, root)
        first = os.path.join(root, "training", "image_2", "000000_10.png")
        with open(first, "rb") as f:
            data = f.read()
        with open(first, "wb") as f:
            f.write(data[: len(data) // 2])
    out = _tool("check_datasets", "--data-root", root, "--device", "cpu")
    if case == "missing_root":
        assert out.returncode == 1 and "does not exist" in out.stderr
        return
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    evals, trains = lines[1:1 + len(EVAL_SPECS)], lines[1 + len(EVAL_SPECS):3 + len(EVAL_SPECS)]
    assert lines[3 + len(EVAL_SPECS)] == "== next ==", out.stdout
    assert re.match(r"  \[ok     \] sceneflow +\d+ TRAIN samples at ", trains[0]), out.stdout
    assert trains[1].startswith("  [absent ] kitti_mix "), out.stdout  # the 3 + 3 KITTI frames are all held out
    assert "anystereo_tpu_torch.tools.reproduce_baseline" in out.stdout
    ok = [line.split()[2] for line in evals if line.startswith("  [ok     ] ")]
    if case == "synthetic_tree":
        assert ok == [key for key, _ in EVAL_SPECS], out.stdout
    else:
        assert re.match(r"  \[BROKEN \] kitti15 .*sample 0 failed", evals[1]), out.stdout
        assert ok == [key for key, _ in EVAL_SPECS if key != "kitti15"], out.stdout
