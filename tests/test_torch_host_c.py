"""The data path's host C against its plain numpy versions and the JAX
package's native module.

`csrc/resize.c` (`utils/resize.resize`), `csrc/colour.c` (the augmentor's
gray and HSV conversions) and `csrc/native_io.c` (`data/native_io`, the
PFM reader and the sparse rescale) are compiled here by the host C compiler
and held to their plain versions (`impl="numpy"`) bit for bit: the same
dtype, shape and bytes.  The port's `native_io` is held to the JAX
package's `anystereo_tpu.data.native_io` (where its module builds) and to
the numpy fallback of `anystereo_tpu/data/augment.py` bit for bit, and
raises the same exception types.  Whole `StereoDataset` samples are made on
the C path and inside `host_c.plain()`, and must be identical.
"""

import os
import threading
import zlib

import numpy as np
import pytest

from anystereo_tpu.data import augment as jaug
from anystereo_tpu.data import native_io as jnative
from anystereo_tpu_torch.data import augment as taug
from anystereo_tpu_torch.data import datasets as tds
from anystereo_tpu_torch.data import frame_utils as tfu
from anystereo_tpu_torch.data import native_io
from anystereo_tpu_torch.ops.kernels import build
from anystereo_tpu_torch.tools import make_synthetic_datasets as synth
from anystereo_tpu_torch.utils import host_c
from anystereo_tpu_torch.utils.resize import resize

NO_JAX_NATIVE = "the JAX package's native module does not build here: only the port's side checked"


@pytest.fixture(scope="module")
def jax_native():
    """Whether the JAX package's native module builds (it builds itself at
    first use: `native/*.so` is not tracked)."""
    return jnative.available()


def _same(got, want, what=""):
    """The same dtype, shape and bytes (so -0.0 and 0.0 differ)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, got.shape, want.dtype,
                                                                  want.shape)
    assert got.tobytes() == want.tobytes(), (what, int((got != want).sum()))


# ---------------------------------------------------------------- resize


def _image(rng, shape, dtype):
    x = rng.rand(*shape) * 255
    return x.astype(np.uint8) if dtype == "uint8" else (x - 60).astype(np.float32)


def _targets(h, w):
    """(size, scale) pairs: up, down, stretched, exactly 2x down, 2x down of
    an odd edge, to one pixel, and a row and a column."""
    return [(None, (1.31, 1.17)), (None, (0.77, 1.9)), (None, (2.5, 0.4)), (None, (0.5, 0.5)),
            ((max(1, w // 2), max(1, h // 2)), None), (((w + 1) // 2, (h + 1) // 2), None),
            ((1, 1), None), ((w + 5, 1), None), ((1, h + 3), None), ((2 * w + 1, 3 * h), None)]


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (13, 17), (31, 47), (30, 46)])
@pytest.mark.parametrize("channels", [None, 1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("mode", ["linear", "cubic"])
def test_resize_c_is_the_plain_version(shape, channels, dtype, mode):
    rng = np.random.RandomState(zlib.crc32(repr((shape, channels, dtype, mode)).encode()))
    img = _image(rng, shape + ((channels,) if channels else ()), dtype)
    checked = 0
    for size, scale in _targets(*shape):
        try:
            want = resize(img, size, mode, scale=scale, impl="numpy")
        except ValueError:  # a scale that rounds a side to 0 pixels
            with pytest.raises(ValueError):
                resize(img, size, mode, scale=scale, impl="c")
            continue
        _same(resize(img, size, mode, scale=scale, impl="c"), want, (size, scale))
        checked += 1
    assert checked >= 7


@pytest.mark.parametrize("n", [1, 2, 7, 160])
def test_resize_of_a_column_and_a_row(n):
    """The evaluator's axis resizes (`eval/validate.py` `_axis_centers`):
    an [N, 1] column to (1, n) and its transpose."""
    axis = np.linspace(-1, 1, 37)
    for img, size in ((axis.reshape(-1, 1), (1, n)), (axis.reshape(1, -1), (n, 1))):
        _same(resize(img, size, "linear", impl="c"), resize(img, size, "linear", impl="numpy"))


def test_resize_of_views_and_other_dtypes():
    """Flipped and cropped views (the augmentor's), float64 and uint16 in."""
    rng = np.random.RandomState(3)
    img = _image(rng, (40, 64, 3), "uint8")
    for view in (img[:, ::-1], img[::-1], img[5:33, 7:50], img[..., ::-1]):
        for mode in ("linear", "cubic"):
            _same(resize(view, None, mode, scale=(1.21, 0.83), impl="c"),
                  resize(view, None, mode, scale=(1.21, 0.83), impl="numpy"))
    for other in (rng.rand(20, 30) * 300, (rng.rand(20, 30, 2) * 4000).astype(np.uint16)):
        for mode in ("linear", "cubic"):
            _same(resize(other, (17, 11), mode, impl="c"), resize(other, (17, 11), mode, impl="numpy"))


def test_resize_default_is_c_and_plain_switches_it(monkeypatch):
    calls = []
    own = host_c.function

    def spy(source, name, *a, **kw):
        calls.append(source)
        return own(source, name, *a, **kw)

    monkeypatch.setattr(host_c, "function", spy)
    img = _image(np.random.RandomState(0), (12, 14, 3), "uint8")
    resize(img, (9, 5), "linear")
    assert calls == ["resize"]
    with host_c.plain():
        resize(img, (9, 5), "linear")
        taug.rgb_to_gray(img)
    assert calls == ["resize"]
    with pytest.raises(ValueError, match="impl 'fast'"):
        resize(img, (9, 5), "linear", impl="fast")


# ---------------------------------------------------------------- colour


def _all_colours():
    c = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij"), -1)
    return c.reshape(4096, 4096, 3).astype(np.uint8)


@pytest.mark.parametrize("fn", ["rgb_to_gray", "rgb_to_hsv"])
def test_colour_c_is_the_plain_version_on_every_colour(fn):
    c = _all_colours()
    _same(getattr(taug, fn)(c, impl="c"), getattr(taug, fn)(c, impl="numpy"))
    view = c[:64, ::-1]  # a strided view, and another leading shape
    _same(getattr(taug, fn)(view[None], impl="c"), getattr(taug, fn)(view[None], impl="numpy"))


@pytest.fixture(scope="module")
def every_hsv_triple():
    """Every uint8 (h, s, v) triple, and the plain version's RGB of each in
    a 32-pixel block (width 32) and in a row's scalar tail (width 31)."""
    flat = _all_colours().reshape(-1, 3)
    block = taug.hsv_to_rgb(flat.reshape(-1, 32, 3), impl="numpy").reshape(-1, 3)
    pad = (-len(flat)) % 31
    tail = taug.hsv_to_rgb(np.concatenate([flat, flat[:pad]]).reshape(-1, 31, 3),
                           impl="numpy").reshape(-1, 3)[:len(flat)]
    return flat, block, tail


@pytest.mark.parametrize("width", [31, 32, 33, 960])
def test_hsv_to_rgb_c_is_the_plain_version_on_every_triple(every_hsv_triple, width):
    """Every triple laid out in rows of `width` (wrapped to fill the last
    row): the C output equals the plain version's RGB of its triple in its
    position's class (block or tail), and the plain version run directly
    at this width on the first 2^18 pixels."""
    flat, block, tail = every_hsv_triple
    pad = (-len(flat)) % width
    order = np.concatenate([np.arange(len(flat)), np.arange(pad)])
    grid = flat[order].reshape(-1, width, 3)
    got = taug.hsv_to_rgb(grid, impl="c")
    in_tail = np.arange(width) >= width - width % 32
    want = np.where(np.broadcast_to(in_tail[None, :, None], grid.shape), tail[order].reshape(grid.shape),
                    block[order].reshape(grid.shape))
    _same(got, want)
    rows = (1 << 18) // width
    _same(got[:rows], taug.hsv_to_rgb(grid[:rows], impl="numpy"))


def test_colour_c_refuses_other_dtypes():
    for fn in (taug.rgb_to_gray, taug.rgb_to_hsv, taug.hsv_to_rgb):
        with pytest.raises(ValueError, match="uint8"):
            fn(np.zeros((4, 5, 3), np.float32), impl="c")


def test_host_c_from_four_threads_at_once():
    """The loader's threads call these at once: no shared state."""
    rng = np.random.RandomState(1)
    imgs = [_image(rng, (60, 90, 3), "uint8") for _ in range(8)]
    want = [(resize(i, None, "linear", scale=(1.3, 0.9), impl="numpy"),
             taug.hsv_to_rgb(taug.rgb_to_hsv(i, impl="numpy"), impl="numpy")) for i in imgs]
    results, errors = {}, []

    def work(k):
        try:
            for _ in range(5):
                i = imgs[k]
                results[k] = (resize(i, None, "linear", scale=(1.3, 0.9)),
                              taug.hsv_to_rgb(taug.rgb_to_hsv(i)))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    for k in range(8):
        for g, w in zip(results[k], want[k]):
            _same(g, w)


# ------------------------------------------------------------- native IO


def _write_pfm(path, arr, little=True):
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if arr.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n" if little else b"1.0\n")
        np.flipud(arr).astype("<f4" if little else ">f4").tofile(f)


@pytest.mark.parametrize("little", [True, False])
@pytest.mark.parametrize("colour", [False, True])
def test_read_pfm_matches_the_jax_module(tmp_path, jax_native, little, colour):
    rng = np.random.RandomState(int(little) + 2 * int(colour))
    arr = (rng.randn(23, 31, 3) if colour else rng.randn(23, 31)).astype(np.float32) * 50
    arr.flat[:3] = [np.inf, -0.0, np.nan]
    p = str(tmp_path / "x.pfm")
    _write_pfm(p, arr, little)
    got = native_io.read_pfm(p)
    _same(got, arr)
    _same(tfu.read_pfm(p), got)
    _same(tfu.read_pfm(p, impl="numpy"), got)
    if not jax_native:
        pytest.skip(NO_JAX_NATIVE)
    _same(got, jnative.read_pfm(p))


def _bad_pfm(tmp_path, kind):
    p = str(tmp_path / f"{kind}.pfm")
    body = {"not_pfm": b"P6\n1 1\n255\n\x00\x00\x00", "malformed": b"Pf\n3 x\n-1.0\n",
            "no_dims": b"Pf\n", "no_scale": b"Pf\n3 2\n", "implausible": b"Pf\n99999999 99999999\n-1.0\n",
            "truncated": b"Pf\n3 2\n-1.0\n" + b"\x00" * 20, "empty": b""}[kind]
    with open(p, "wb") as f:
        f.write(body)
    return p


PFM_ERRORS = {"missing": FileNotFoundError, "not_pfm": ValueError, "malformed": ValueError,
              "no_dims": ValueError, "no_scale": ValueError, "implausible": ValueError,
              "truncated": ValueError, "empty": ValueError, "directory": ValueError, "not_str": TypeError}


@pytest.mark.parametrize("kind", list(PFM_ERRORS))
def test_read_pfm_raises_what_the_jax_module_raises(tmp_path, jax_native, kind):
    if kind == "missing":
        path = str(tmp_path / "none.pfm")
    elif kind == "directory":
        path = str(tmp_path)
    elif kind == "not_str":
        path = tmp_path / "x.pfm"
    else:
        path = _bad_pfm(tmp_path, kind)
    with pytest.raises(PFM_ERRORS[kind]):
        native_io.read_pfm(path)
    if not jax_native:
        pytest.skip(NO_JAX_NATIVE)
    with pytest.raises(PFM_ERRORS[kind]):
        jnative.read_pfm(path)


def _jax_fallback_scatter(monkeypatch, flow, valid, fx, fy):
    """`anystereo_tpu/data/augment.py`'s numpy fallback of the rescale."""
    with monkeypatch.context() as m:
        m.setattr(jnative, "available", lambda: False)
        return jaug.StereoAugmentor(jaug.AugmentorConfig(), sparse=True)._resize_sparse_flow(flow, valid, fx, fy)


def _sparse(rng, h, w, share=0.2):
    valid = (rng.rand(h, w) < share).astype(np.float32)
    flow = np.stack([rng.rand(h, w).astype(np.float32) * 200 - 20, rng.randn(h, w).astype(np.float32)], -1)
    return flow * valid[..., None], valid


@pytest.mark.parametrize("scale", [(1.37, 0.81), (0.5, 0.5), (1.0, 1.0), (2.2, 1.7), (0.3, 1.25)])
def test_scatter_resize_sparse_matches_the_jax_module_and_fallback(monkeypatch, jax_native, scale):
    rng = np.random.RandomState(int(scale[0] * 100))
    flow, valid = _sparse(rng, 75, 248)
    valid[0, :4] = [np.nan, 2.0, 0.999, 1.0]
    fx, fy = scale
    fallback = _jax_fallback_scatter(monkeypatch, flow, valid, fx, fy)
    for got, want in zip(native_io.scatter_resize_sparse(flow, valid, fx, fy, numpy_rules=True), fallback):
        _same(got, want)
    plain = taug.StereoAugmentor(taug.AugmentorConfig(), sparse=True)._resize_sparse_flow(
        flow, valid, fx, fy, impl="numpy")
    for got, want in zip(taug.StereoAugmentor(taug.AugmentorConfig(), sparse=True)._resize_sparse_flow(
            flow[:, ::-1], valid[:, ::-1], fx, fy), taug.StereoAugmentor(
            taug.AugmentorConfig(), sparse=True)._resize_sparse_flow(flow[:, ::-1], valid[:, ::-1], fx, fy,
                                                                     impl="numpy")):
        _same(got, want)  # a flipped view, as the augmentor may pass
    for got, want in zip(plain, fallback):
        _same(got, want)
    if not jax_native:
        pytest.skip(NO_JAX_NATIVE)
    for got, want in zip(native_io.scatter_resize_sparse(flow, valid, fx, fy),
                         jnative.scatter_resize_sparse(flow, valid, fx, fy)):
        _same(got, want)


def test_sample_queries_matches_the_jax_module(jax_native):
    rng = np.random.RandomState(4)
    vals = rng.rand(100).astype(np.float32)
    coords = rng.rand(100, 2).astype(np.float32)
    idx = rng.randint(0, 100, 257).astype(np.int64)
    got = native_io.sample_queries(vals, coords, idx)
    _same(got[0], vals[idx])
    _same(got[1], coords[idx])
    if not jax_native:
        pytest.skip(NO_JAX_NATIVE)
    for g, w in zip(got, jnative.sample_queries(vals, coords, idx)):
        _same(g, w)


def _native_cases():
    f, v = np.zeros((6, 8, 2), np.float32), np.zeros((6, 8), np.float32)
    vals, coords = np.zeros(4, np.float32), np.zeros((4, 2), np.float32)
    return {
        "scatter_valid_shape": (ValueError, "scatter_resize_sparse", (f, np.zeros((3, 4), np.float32), 1.5, 1.5)),
        "scatter_flow_shape": (ValueError, "scatter_resize_sparse", (np.zeros((6, 8, 3), np.float32), v, 1.5, 1.5)),
        "scatter_list": (TypeError, "scatter_resize_sparse", (f.tolist(), v, 1.5, 1.5)),
        "scatter_float64": (TypeError, "scatter_resize_sparse", (f.astype(np.float64), v, 1.5, 1.5)),
        "scatter_scale_word": (ValueError, "scatter_resize_sparse", (f, v, "one", 1.5)),
        "scatter_scale_none": (TypeError, "scatter_resize_sparse", (f, v, None, 1.5)),
        "scatter_negative": (ValueError, "scatter_resize_sparse", (f, v, -1.5, 1.5)),
        "queries_out_of_range": (IndexError, "sample_queries", (vals, coords, np.array([10], np.int64))),
        "queries_negative": (IndexError, "sample_queries", (vals, coords, np.array([0, -1], np.int64))),
        "queries_length": (ValueError, "sample_queries", (np.zeros(10, np.float32), coords, np.array([7]))),
        "queries_float_index": (TypeError, "sample_queries", (vals, coords, np.array([1.0]))),
    }


@pytest.mark.parametrize("case", list(_native_cases()))
def test_native_io_raises_what_the_jax_module_raises(jax_native, case):
    kind, fn, args = _native_cases()[case]
    with pytest.raises(kind):
        getattr(native_io, fn)(*args)
    if not jax_native:
        pytest.skip(NO_JAX_NATIVE)
    with pytest.raises(kind):
        getattr(jnative, fn)(*args)


# ---------------------------------------------------------- whole samples


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("host_c"))
    rng = np.random.RandomState(0)
    synth.gen_sceneflow(root, rng, n_train=2, n_test=1, h=96, w=160)
    synth.gen_kitti15(root, rng, n=2, h=64, w=160)
    return root


SAMPLES = {
    "standard": ("sceneflow", dict()),
    "multi_scale": ("sceneflow", dict(multi_scale=True, scale_min=1.0, scale_max=1.6, inp_size=(32, 64))),
    "sparse": ("kitti", dict()),
    "sparse_multi_scale": ("kitti", dict(multi_scale=True, scale_min=1.0, scale_max=1.6, inp_size=(24, 64))),
}


@pytest.mark.parametrize("mode", list(SAMPLES))
def test_whole_sample_is_the_same_on_the_c_and_plain_paths(trees, mode, monkeypatch):
    data, kw = SAMPLES[mode]
    aug = taug.AugmentorConfig(crop_size=(40, 72), yjitter=data == "sceneflow", min_scale=-0.2,
                               max_scale=0.4, spatial_aug_prob=1.0, eraser_prob=1.0)
    if data == "sceneflow":
        ds = tds.SceneFlowDataset(trees, aug, **kw)
    else:
        ds = tds.KittiDataset(trees, aug, **kw)
    calls = {}
    own = host_c.function

    def counted(source, name, *a, **k):
        calls[name] = calls.get(name, 0) + 1
        return own(source, name, *a, **k)

    monkeypatch.setattr(host_c, "function", counted)
    for i in range(2):
        got = ds.__getitem__(i, rng=np.random.RandomState(40 + i))
        with host_c.plain():
            want = ds.__getitem__(i, rng=np.random.RandomState(40 + i))
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k], k)
    assert {"resize_linear_u8", "rgb_to_gray", "rgb_to_hsv", "hsv_to_rgb"} <= set(calls), calls
    assert ("scatter_resize_sparse" in calls) == (data == "kitti"), calls
    assert ("pfm_header" in calls) == (data == "sceneflow"), calls


# ------------------------------------------------------------ no fallback


NO_COMPILER = {
    "resize": lambda p: resize(np.zeros((5, 6, 3), np.uint8), (3, 2), "linear"),
    "colour": lambda p: taug.rgb_to_gray(np.zeros((5, 6, 3), np.uint8)),
    "native_io": lambda p: tfu.read_pfm(p),
}


@pytest.mark.parametrize("source", list(NO_COMPILER))
def test_missing_compiler_raises(tmp_path, monkeypatch, source):
    """With no C compiler and nothing built, each source's functions raise
    and name the compiler searched and the source; nothing falls back to
    numpy, and native_io says it is not available."""
    p = str(tmp_path / "a.pfm")
    tfu.write_pfm(p, np.ones((3, 4), np.float32))
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(RuntimeError, match=f"no host C compiler to build .*{source}.c.*no-such-cc"):
        NO_COMPILER[source](p)
    if source == "native_io":
        assert not native_io.available()
    assert not (tmp_path / "kernels").exists() or not any((tmp_path / "kernels").iterdir())


def test_new_sources_build_with_the_host_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_LIBS", {})
    names = ["colour", "native_io", "resize"]
    assert sorted(build.build(names)) == names
    assert build.build(names) == {}
    assert "-ffp-contract=off" in build.C_FLAGS and not any("fast-math" in f for f in build.C_FLAGS)
    assert all(os.path.exists(build.library_path(n)) for n in names)
