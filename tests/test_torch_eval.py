"""The evaluation entry point of the PyTorch port vs the JAX package:
`InputPadder`, the metrics, the left-right-consistency occlusion mask, the
padding protocols, `utils/resize` against OpenCV, `Validator.infer`,
`validate_dataset` and `make_eval_step`.

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
`validate_dataset`: every metric key within 1e-4.
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
from anystereo_tpu_torch.config import ModelConfig
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


def test_validate_dataset_without_provider_and_unported_options(models):
    _, _, tm = models
    ds = _MemoryDataset(1)
    got = tval.validate_dataset(tm, ds, valid_iters=1, device="cpu")
    assert set(got) == {"epe", "d1", "thres1", "thres2", "thres3"}
    no_pair = _MemoryDataset(1)
    no_pair.disparity_pair = lambda i: None
    assert tval.lr_consistency_occ_provider("cpu")(no_pair, 0) is None
    with pytest.raises(ValueError):
        tval.validate_dataset(tm, ds, report_dir="out", device="cpu")
    with pytest.raises(ValueError):
        tval.validate_dataset(tm, ds, dump_images=True, device="cpu")


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
