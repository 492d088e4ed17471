"""The evaluation entry point of the PyTorch port vs the JAX package:
`InputPadder`, the metrics, the left-right-consistency occlusion mask, the
padding protocols, `utils/resize` against OpenCV, `Validator.infer`,
`validate_dataset` and `make_eval_step`; and the file side of evaluation: the
occlusion providers that read ground-truth files, `build_eval_dataset` by
name, `run_validation` of a checkpoint, the result file and the dumped
images (`eval/reporting.py`, `eval/visualization.py`).

The model cases run the IGEV model at `max_disp` 32 in fp32 with 2
iterations on 30x61 frames (padded to 32x64 by the evaluator), on flax
variables seeded with numpy and carried over with `from_flax`.

Tolerances.  Padder, grids, masks: exact or 1e-6.  Metrics: 1e-6 relative.
`utils/resize` against `cv2.resize`: 1e-4 of the value range (measured 4e-7
of it: both sum float32 products of the same taps).  `Validator.infer` where
both sides feed the model identical inputs (scale 1, fixed upscale,
bucketing): 1e-3 px, the whole-forward tolerance of `tests/test_torch_model.py`.
Where the port's resize feeds the model and OpenCV feeds the JAX one
(`scale_test` 1.5, `eval_others`), the inputs differ by up to 1e-4 of 255; the
band stays 1e-3 px (measured 2e-5 px, as with identical inputs).
`validate_dataset`: every metric key within 1e-4.  Occlusion masks, dataset
lists, the result file's bytes, the colour maps and `run_validation` against
`validate_dataset` with the same weights: exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anystereo_tpu.config import ModelConfig as JaxConfig
from anystereo_tpu.eval import metrics as jmet
from anystereo_tpu.eval import occlusion as jocc
from anystereo_tpu.eval import validate as jval
from anystereo_tpu.eval.padder import InputPadder as JaxPadder
from anystereo_tpu.nn.model import AnyStereo as JaxAnyStereo
from anystereo_tpu.train.step import make_eval_step as jax_make_eval_step
from anystereo_tpu_torch.config import ModelConfig, TrainConfig
from anystereo_tpu_torch.data.png import read_png
from anystereo_tpu_torch.eval import metrics as tmet
from anystereo_tpu_torch.eval import occlusion as tocc
from anystereo_tpu_torch.eval import validate as tval
from anystereo_tpu_torch.eval.padder import InputPadder
from anystereo_tpu_torch.nn.model import AnyStereo
from anystereo_tpu_torch.ops.kernels.lookup_linear import gather_rows_linear
from anystereo_tpu_torch.train.step import make_eval_step
from anystereo_tpu_torch.utils.resize import resize
from anystereo_tpu_torch.utils.weights import from_flax

from test_torch_model import _seeded_variables

MAX_DISP, ITERS, H, W = 32, 2, 30, 61


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------- padder


@pytest.mark.parametrize("mode", ["sintel", "kitti"])
@pytest.mark.parametrize("h,w,divis", [(30, 61, 32), (375, 1242, 32), (64, 96, 32), (17, 40, 16)])
def test_input_padder(rng, mode, h, w, divis):
    x = rng.rand(2, h, w, 3).astype(np.float32)
    y = rng.rand(2, h, w, 1).astype(np.float32)
    jp, tp = JaxPadder(x.shape, mode=mode, divis_by=divis), InputPadder(x.shape, mode=mode, divis_by=divis)
    assert tp.get_pad_num() == jp.get_pad_num() and tp.padded_shape == jp.padded_shape
    want = jp.pad(jnp.asarray(x), jnp.asarray(y))
    got = tp.pad(_t(x), _t(y))
    for g, w_ in zip(got, want):
        assert g.shape[1] % divis == 0 and g.shape[2] % divis == 0
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    np.testing.assert_array_equal(tp.unpad(got[0]).numpy(), x)
    np.testing.assert_array_equal(tp.unpad(got[0][..., 0]).numpy(), x[..., 0])  # [B, H, W]
    assert InputPadder((h, w), mode=mode, divis_by=divis).get_pad_num() == tp.get_pad_num()


# -------------------------------------------------------------------- metrics


def _metric_inputs(rng, nan_pred=False):
    b, h, w = 2, 12, 20
    gt = (rng.rand(b, h, w) * 60).astype(np.float32)
    pred = (gt + rng.randn(b, h, w) * 3).astype(np.float32)
    valid = rng.rand(b, h, w) > 0.3
    gt[~valid] = np.inf  # missing ground truth, outside the mask only
    if nan_pred:
        pred[0, :2] = np.nan
    return pred, gt, valid


@pytest.mark.parametrize("nan_pred", [False, True])
def test_each_metric(rng, nan_pred):
    pred, gt, valid = _metric_inputs(rng, nan_pred)
    args_t, args_j = (_t(pred), _t(gt), _t(valid)), (jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(valid))
    pairs = [(tmet.epe_metric(*args_t), jmet.epe_metric(*args_j)),
             (tmet.d1_metric(*args_t), jmet.d1_metric(*args_j))]
    pairs += [(tmet.thres_metric(*args_t, t), jmet.thres_metric(*args_j, t)) for t in (1.0, 2.0, 3.0)]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, equal_nan=True)
    if nan_pred:  # a non-finite prediction is an error, not a pass
        assert np.isnan(float(pairs[0][0])) and float(pairs[1][0]) > 0
        only_nan = np.zeros_like(valid)
        only_nan[0, :2] = valid[0, :2]
        assert float(tmet.d1_metric(_t(pred), _t(gt), _t(only_nan))) == 1.0
        assert float(tmet.thres_metric(_t(pred), _t(gt), _t(only_nan), 3.0)) == 1.0
    else:
        assert np.isfinite(float(pairs[0][0]))  # inf ground truth outside the mask never enters


def test_masked_mean_skips_images_without_valid_pixels(rng):
    pred, gt, valid = _metric_inputs(rng)
    valid[1] = False
    got, want = tmet.epe_metric(_t(pred), _t(gt), _t(valid)), jmet.epe_metric(pred, gt, valid)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(tmet.epe_metric(_t(pred), _t(gt), _t(np.zeros_like(valid)))) == 0.0


@pytest.mark.parametrize("occ_share", [0.0, 0.005, 0.3, 0.999, None])
def test_compute_metrics_and_cover_filter(rng, occ_share):
    """The `_occ` / `_noc` groups appear only when their mask covers 1% of
    the valid pixels."""
    pred, gt, valid = _metric_inputs(rng)
    occ = None if occ_share is None else rng.rand(*valid.shape) < occ_share
    want = jmet.compute_metrics(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(valid),
                                None if occ is None else jnp.asarray(occ))
    got = tmet.compute_metrics(_t(pred), _t(gt), _t(valid), None if occ is None else _t(occ))
    assert set(got) == set(want) and all(isinstance(v, float) for v in got.values())
    assert ("epe_occ" in got) == (occ_share in (0.3, 0.999))
    assert ("epe_noc" in got) == (occ_share in (0.0, 0.005, 0.3))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert tmet.mask_cover_ok(_t(valid), _t(valid)) and not tmet.mask_cover_ok(
        _t(np.zeros_like(valid)), _t(valid))


def test_iou_metric(rng):
    p, g = rng.rand(3, 8, 9) > 0.5, rng.rand(3, 8, 9) > 0.4
    p[2], g[2] = False, False  # an empty union counts 0
    np.testing.assert_allclose(float(tmet.iou_metric(_t(p), _t(g))),
                               float(jmet.iou_metric(jnp.asarray(p), jnp.asarray(g))), rtol=1e-6)


def test_average_meter_sums_nonfinite():
    tm, jm = tmet.AverageMeterDict(), jmet.AverageMeterDict()
    for d in ({"epe": 1.0, "d1": 0.5}, {"epe": float("nan"), "d1": 0.25, "epe_occ": 2.0},
              {"epe": 3.0, "d1": None}):
        tm.update(d)
        jm.update(d)
    got, want = tm.mean(), jm.mean()
    assert set(got) == set(want) == {"epe", "d1", "epe_occ"}
    assert np.isnan(got["epe"]) and got["d1"] == want["d1"] == 0.375 and got["epe_occ"] == 2.0


# ------------------------------------------------------------------ occlusion


def _disparity_pair(rng, h=9, w=40):
    """A left disparity with a step (an occluding edge) and the right view's
    that agrees with it away from the edge."""
    dl = np.full((1, h, w), 4.0, np.float32)
    dl[:, :, w // 2:] = 12.0
    dl += rng.rand(1, h, w).astype(np.float32) * 0.2
    dr = np.full((1, h, w), 4.0, np.float32)
    dr[:, :, w // 2 - 12:] = 12.0
    return dl, dr


def test_warp_disparity_and_occ_mask(rng):
    dl, dr = _disparity_pair(rng)
    before = gather_rows_linear.launches
    np.testing.assert_allclose(tocc.warp_disparity(_t(dr), _t(dl)).numpy(),
                               np.asarray(jocc.warp_disparity(jnp.asarray(dr), jnp.asarray(dl))),
                               rtol=1e-6, atol=1e-6)
    got = tocc.occ_mask(_t(dl), _t(dr))
    assert gather_rows_linear.launches == before  # the CPU takes the plain version
    want = np.asarray(jocc.occ_mask(jnp.asarray(dl), jnp.asarray(dr)))
    assert got.dtype == torch.bool and 0 < int(got.sum()) < got.numel()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tocc.occ_mask(_t(dl), _t(dr), thresh=0.05).numpy(),
                                  np.asarray(jocc.occ_mask(jnp.asarray(dl), jnp.asarray(dr), 0.05)))


# --------------------------------------------------------------------- resize


@pytest.mark.parametrize("mode", ["cubic", "linear"])
@pytest.mark.parametrize("shape,size", [
    ((30, 61, 3), (41, 20)),      # down by 1.5 (w, h)
    ((30, 61, 3), (122, 60)),     # up by 2
    ((37, 53), (18, 13)),         # down by ~2.95, one channel
    ((20, 41), (61, 30)),         # up by 1.5, one channel
    ((33, 47, 2), (50, 32)),      # a coordinate grid, nearly the same size
    ((21, 1), (1, 30)),           # one axis as a column
    ((96, 312, 3), (313, 95)),    # one pixel either way
])
def test_resize_matches_opencv(rng, mode, shape, size):
    cv2 = pytest.importorskip("cv2")
    img = (rng.rand(*shape) * 255).astype(np.float32)
    flag = cv2.INTER_CUBIC if mode == "cubic" else cv2.INTER_LINEAR
    want = cv2.resize(img, size, interpolation=flag)
    got = resize(img, size, mode)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * 255)


def test_resize_rejects_bad_arguments(rng):
    img = rng.rand(4, 5).astype(np.float32)
    with pytest.raises(ValueError):
        resize(img, (3, 3), "area")
    with pytest.raises(ValueError):
        resize(img[None, None], (3, 3))
    out = resize(img, (5, 4))  # same size: a copy
    assert np.array_equal(out, img) and out is not img


# ---------------------------------------------------------- padding protocols


def _frame(rng, h=H, w=W):
    return (rng.rand(1, h, w, 3) * 255).astype(np.float32), (rng.rand(1, h, w, 3) * 255).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 1.5, 2.95])
@pytest.mark.parametrize("h,w", [(30, 61), (37, 53), (32, 64)])
def test_pad_protocols_match_jax(rng, scale, h, w):
    pytest.importorskip("cv2")  # the JAX side resizes with OpenCV
    left, right = _frame(rng, h, w)
    img_tol = dict(rtol=0, atol=0 if scale == 1.0 else 1e-4 * 255)
    # _pad_common: images, sizes and pad numbers
    want, got = jval._pad_common(left, right, scale, 32), tval._pad_common(left, right, scale, 32, "cpu")
    for i in (0, 1):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), **img_tol)
    assert tuple(got[2:]) == tuple(tuple(v) for v in want[2:])
    # the dense grid
    wl, wr, wys, wxs, ws = jval.pad_for_dense_grid(left, right, scale, 32)
    gl, gr, gys, gxs, gs = tval.pad_for_dense_grid(left, right, scale, 32, "cpu")
    assert gs == ws and gys.shape == (h,) and gxs.shape == (w,) and gys.dtype == torch.float32
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **img_tol)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), **img_tol)
    np.testing.assert_allclose(gys.numpy(), np.asarray(wys), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gxs.numpy(), np.asarray(wxs), rtol=0, atol=1e-6)
    # the queries
    _, _, wc, _ = jval.pad_for_queries(left, right, scale, 32)
    _, _, gc, gs = tval.pad_for_queries(left, right, scale, 32, "cpu")
    assert gc.shape == (1, h * w, 2) and gs == float(scale)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=0, atol=1e-6)


@pytest.mark.parametrize("up,divis", [(2, 32), (4, 16)])
def test_pad_for_fixed_upscale_matches_jax(rng, up, divis):
    left, right = _frame(rng)
    want = jval.pad_for_fixed_upscale(left, right, up, divis)
    got = tval.pad_for_fixed_upscale(left, right, up, divis, "cpu")
    for g, w_ in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert got[4] == want[4] == float(up) and got[2].shape == (H * up,)


# ------------------------------------------------------------------ the model


@pytest.fixture(scope="module")
def models():
    """(JAX model, its variables, the port's model with the same weights)."""
    rng = np.random.RandomState(3)
    left, right = _frame(rng, 32, 64)
    jm = JaxAnyStereo(JaxConfig(max_disp=MAX_DISP, compute_dtype="float32"))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), left, right, iters=1, mode="eval"))
    variables = _seeded_variables(shapes)
    tm = AnyStereo(ModelConfig(max_disp=MAX_DISP, compute_dtype="float32"))
    tm.load_state_dict(from_flax(variables), strict=True)
    return jm, variables, tm.eval()


INFER_CASES = {
    "scale1": (dict(), None, 1e-3),
    "fixed_upscale2": (dict(fixed_upscale=2), None, 1e-3),
    "bucket64": (dict(), 64, 1e-3),
    "bucket64_fixed_upscale2": (dict(fixed_upscale=2), 64, 1e-3),
    "scale1.5": (dict(scale_test=1.5), None, 1e-3),
    "eval_others1.5": (dict(scale_test=1.5, eval_others=True), None, 1e-3),
}


@pytest.mark.parametrize("case", list(INFER_CASES))
def test_validator_infer_matches_jax(models, case):
    pytest.importorskip("cv2")
    kw, bucket, atol = INFER_CASES[case]
    jm, variables, tm = models
    rng = np.random.RandomState(11)
    left, right = (a[0] for a in _frame(rng))
    want = jval.Validator(jm, variables, ITERS, bucket=bucket).infer(left, right, **kw)
    got = tval.Validator(tm, ITERS, bucket=bucket, device="cpu").infer(left, right, **kw)
    up = kw.get("fixed_upscale", 1)
    assert got.shape == want.shape == (H * up, W * up) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


class _MemoryDataset:
    """Frames held in memory, with the right view's ground truth."""

    def __init__(self, n, seed=5):
        rng = np.random.RandomState(seed)
        self.frames = []
        for _ in range(n):
            left, right = (a[0] for a in _frame(rng))
            dl, dr = _disparity_pair(rng, H, W)
            valid = (rng.rand(H, W) > 0.1).astype(np.float32)
            self.frames.append((left, right, dl[0], dr[0], valid))
        self.image_list = [[f"mem/{i}/left.png", f"mem/{i}/right.png"] for i in range(n)]
        self.disparity_list = [f"mem/{i}/left.pfm" for i in range(n)]

    def __len__(self):
        return len(self.frames)

    def _load_raw(self, i):
        left, right, dl, _, valid = self.frames[i]
        return left, right, np.stack([dl, np.zeros_like(dl)], axis=-1), valid

    def disparity_pair(self, i):
        return self.frames[i][2], self.frames[i][3]


def _jax_occ_provider(ds, i):
    dl, dr = ds.disparity_pair(i)
    return np.asarray(jocc.occ_mask(jnp.asarray(dl)[None], jnp.asarray(dr)[None]))[0]


@pytest.mark.parametrize("valid_from_gt", [False, True])
def test_validate_dataset_matches_jax(models, valid_from_gt):
    jm, variables, tm = models
    ds = _MemoryDataset(3)
    want = jval.validate_dataset(jm, variables, ds, valid_iters=ITERS, occ_provider=_jax_occ_provider,
                                 valid_from_gt=valid_from_gt, max_images=2)
    got = tval.validate_dataset(tm, ds, valid_iters=ITERS, valid_from_gt=valid_from_gt, max_images=2,
                                occ_provider=tval.lr_consistency_occ_provider("cpu"), device="cpu")
    assert set(got) == set(want)
    assert {"epe", "d1", "thres1", "thres2", "thres3", "epe_occ", "d1_noc"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)


def test_validate_dataset_without_provider_and_unported_options(models, tmp_path):
    """Without a provider only the overall metrics; `report_dir` and
    `dump_images`, once not ported, write the result file and the dumps."""
    _, _, tm = models
    ds = _MemoryDataset(1)
    got = tval.validate_dataset(tm, ds, valid_iters=1, device="cpu")
    assert set(got) == {"epe", "d1", "thres1", "thres2", "thres3"}
    no_pair = _MemoryDataset(1)
    no_pair.disparity_pair = lambda i: None
    assert tval.lr_consistency_occ_provider("cpu")(no_pair, 0) is None
    report = tval.validate_dataset(tm, ds, valid_iters=1, report_dir=str(tmp_path), dump_images=True,
                                   device="cpu")
    assert report == got
    lines = (tmp_path / "result.txt").read_text().splitlines()
    assert lines[0].startswith("0_0000 d1=") and lines[1] == "== summary =="
    assert len(lines) == 2 + len(got)
    for name in ("disp_0_0000.png", "errmap_0_0000.png"):
        img = read_png(str(tmp_path / "output" / name))
        assert img.shape == (H, W, 3) and img.dtype == np.uint8


def test_make_eval_step_matches_jax(models):
    jm, variables, tm = models
    rng = np.random.RandomState(13)
    left, right = _frame(rng, 32, 64)
    coords = (rng.rand(1, 200, 2) * 2 - 1).astype(np.float32)
    scale = np.asarray([1.5], np.float32)
    want = jax_make_eval_step(jm, ITERS)(variables["params"], jnp.asarray(left), jnp.asarray(right),
                                         jnp.asarray(coords), jnp.asarray(scale))
    got = make_eval_step(tm, ITERS, device="cpu")(_t(left), _t(right), _t(coords), _t(scale))
    assert got.shape == (1, 200) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)


def test_eval_entry_points_never_fall_back_to_cpu(models, monkeypatch):
    _, _, tm = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.RandomState(0)
    left, right = _frame(rng)
    for call in (lambda: tval.Validator(tm), lambda: tval.validate_dataset(tm, _MemoryDataset(1)),
                 lambda: make_eval_step(tm), lambda: tval.lr_consistency_occ_provider(),
                 lambda: tval.pad_for_dense_grid(left, right, 1.0, 32),
                 lambda: tval.pad_for_queries(left, right, 1.0, 32),
                 lambda: tval.pad_for_fixed_upscale(left, right, 2)):
        with pytest.raises(RuntimeError):
            call()
    assert tval.Validator(tm, device="cpu").device.type == "cpu"


# ------------------------------------------------------ evaluation from files


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    """The synthetic trees of `tools/make_synthetic_datasets.py`, with the
    right view's SceneFlow disparity beside the left's (a shifted copy, so
    the left-right check finds occluded pixels)."""
    cv2 = pytest.importorskip("cv2")  # noqa: F841 - the tree writer uses it
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
    import make_synthetic_datasets as synth
    from anystereo_tpu.data.frame_utils import read_pfm, write_pfm

    root = str(tmp_path_factory.mktemp("eval_tree"))
    rng = np.random.RandomState(0)
    synth.gen_sceneflow(root, rng, n_train=1, n_test=2, h=H, w=W)
    synth.gen_kitti15(root, rng, n=2, h=H, w=W)
    synth.gen_kitti12(root, rng, n=2, h=H, w=W)
    synth.gen_middlebury(root, rng, hf=32, wf=64)
    synth.gen_eth3d(root, rng, h=H, w=W)
    for left in sorted(__import__("glob").glob(os.path.join(root, "disparity", "*", "*", "*", "left", "*.pfm"))):
        d = read_pfm(left)
        d[:, W // 2:] += 6.0  # an occluding step in the left view only
        right = left.replace("/left/", "/right/")
        os.makedirs(os.path.dirname(right), exist_ok=True)
        write_pfm(right, read_pfm(left))
        write_pfm(left, d)
    mid14 = os.path.join(root, "2014", "scene_c")
    os.makedirs(mid14)
    write_pfm(os.path.join(mid14, "disp0.pfm"), (rng.rand(H, W) * 20).astype(np.float32))
    return root


EVAL_NAMES = ["sceneflow", "kitti15", "kitti12", "middlebury_F", "middlebury_H", "middlebury_Q",
              "middlebury_Q_F", "middlebury_H_F", "eth3d"]


@pytest.mark.parametrize("name", EVAL_NAMES)
def test_build_eval_dataset_and_providers_match_jax(eval_tree, name):
    jds, jup, jocc_fn, jvalid = jval.build_eval_dataset(name, eval_tree)
    tds, tup, tocc_fn, tvalid = tval.build_eval_dataset(name, eval_tree, device="cpu")
    assert tds.image_list == jds.image_list and tds.disparity_list == jds.disparity_list
    assert len(tds) > 0 and (tup, tvalid) == (jup, jvalid)
    masks = 0
    for i in range(len(tds)):
        want, got = jocc_fn(jds, i), tocc_fn(tds, i)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.dtype == np.bool_ and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
            masks += int(0 < got.sum() < got.size)
    assert masks > 0  # each provider found occluded and visible pixels


def test_nocc_provider_without_occlusion_ground_truth(eval_tree):
    import os

    ds = jds = type("DS", (), {})()
    ds.disparity_list = [os.path.join(eval_tree, "2014", "scene_c", "disp0.pfm")]
    assert jval.nocc_mask_occ_provider(jds, 0) is None and tval.nocc_mask_occ_provider(ds, 0) is None
    ds.disparity_list = [os.path.join(eval_tree, "none", "left", "0000.pfm")]
    assert tval.sceneflow_occ_provider(ds, 0, device="cpu") is None
    assert tval.kitti_occ_provider(ds, 0) is None


@pytest.fixture
def two_threads():
    """Two intra-op threads for one test (see `tests/test_torch_trainer.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_run_validation_from_a_port_checkpoint(models, eval_tree, tmp_path, two_threads):
    """`run_validation` builds the model, restores the checkpoint's weights
    and validates by name: the metrics of `validate_dataset` with those
    weights, and on KITTI 2015 the JAX package's with its own (1e-4)."""
    from anystereo_tpu_torch.train.state import create_train_state, save_checkpoint

    jm, variables, tm = models
    cfg = ModelConfig(max_disp=MAX_DISP, compute_dtype="float32")
    save_checkpoint(str(tmp_path), create_train_state(tm, TrainConfig(), device="cpu"))
    for name in ("kitti15", "sceneflow"):
        got = tval.run_validation(cfg, str(tmp_path), name, eval_tree, valid_iters=ITERS, max_images=2,
                                  device="cpu")
        ds, up, occ, from_gt = tval.build_eval_dataset(name, eval_tree, device="cpu")
        want = tval.validate_dataset(tm, ds, ITERS, max_images=2, fixed_upscale=up, occ_provider=occ,
                                     valid_from_gt=from_gt, device="cpu")
        assert got == want and "epe_occ" in got
        if name != "kitti15":  # one JAX compile of the evaluator is enough
            continue
        jds, jup, jocc_fn, jfrom_gt = jval.build_eval_dataset(name, eval_tree)
        jwant = jval.validate_dataset(jm, variables, jds, ITERS, max_images=2, fixed_upscale=jup,
                                      occ_provider=jocc_fn, valid_from_gt=jfrom_gt)
        assert set(jwant) == set(got)
        for k in jwant:
            np.testing.assert_allclose(got[k], jwant[k], rtol=0, atol=1e-4, err_msg=f"{name} {k}")


def test_result_file_is_the_jax_writers(tmp_path):
    from anystereo_tpu.eval import reporting as jrep
    from anystereo_tpu_torch.eval import reporting as trep

    rng = np.random.RandomState(4)
    lines = [{k: float(rng.rand() * 10) for k in ("epe", "d1", "thres3", "epe_occ")} for _ in range(3)]
    for rep, path in ((jrep, tmp_path / "jax.txt"), (trep, tmp_path / "port.txt")):
        for i, m in enumerate(lines):
            rep.append_result_line(str(path), f"frame_{i:04d}", m)
        rep.write_summary(str(path), lines[0], header="summary")
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


@pytest.mark.parametrize("max_disp", [None, 25.0])
def test_colour_maps_and_dumps_match_jax(tmp_path, max_disp):
    from PIL import Image

    from anystereo_tpu.eval import reporting as jrep
    from anystereo_tpu.eval import visualization as jvis
    from anystereo_tpu_torch.eval import reporting as trep
    from anystereo_tpu_torch.eval import visualization as tvis

    rng = np.random.RandomState(6)
    gt = (rng.rand(H, W) * 30).astype(np.float32)
    gt[rng.rand(H, W) < 0.2] = 0
    pred = gt + (rng.randn(H, W) * 3).astype(np.float32)
    valid = gt > 2
    np.testing.assert_array_equal(tvis.disp_to_color(pred, max_disp), jvis.disp_to_color(pred, max_disp))
    for v in (None, valid):
        np.testing.assert_array_equal(tvis.disp_error_image(pred, gt, v), jvis.disp_error_image(pred, gt, v))
    for rep, sub in ((jrep, "jax"), (trep, "port")):
        rep.dump_disparity_png(str(tmp_path / sub), "f", pred, max_disp)
        rep.dump_error_map_png(str(tmp_path / sub), "f", pred, gt, valid)
    for name in ("disp_f.png", "errmap_f.png"):
        np.testing.assert_array_equal(np.array(Image.open(tmp_path / "port" / name)),
                                      read_png(str(tmp_path / "jax" / name)))


def test_tensorboard_reporter_without_tensorboard(monkeypatch):
    import sys

    from anystereo_tpu_torch.eval.reporting import TensorBoardReporter

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    rep = TensorBoardReporter("unused")
    assert rep.writer is None
    rep.scalars("val", {"epe": 1.0}, 0)
    rep.image("val", np.zeros((4, 5, 3), np.uint8), 0)
    rep.flush()
