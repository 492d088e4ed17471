"""Reference-checkpoint import of the PyTorch port (`utils/torch_convert.py`,
`utils/torch_compat.py`, `ops/lookup.internal_to_reference_perm`,
`config.reference_regime_config`, `tools/convert_checkpoint.py`) against the
JAX package's converter.

The reference model is not in the repo, so the reference keys and shapes
come from the JAX converter itself: its primitives (`conv`, `deconv`, `bn`,
`layernorm2d`, `dense`) are replaced for one run by recorders that read the
shape of each flax target on a `reference_regime_config` init
(`jax.eval_shape`) and name the source tensors in the torch layout; the
membership tests of `residual_block` are answered from the same tree, and
the aliases the converter only consumes (`num_batches_tracked`, `norm3`,
the dead `bn` of `BasicConv(bn=False)`) are recorded where it consumes
them.  The result for `ModelConfig()` and `raft_config()` widths is
committed as `tests/data/reference_keys_{igev,raft}.json` (what
`chip_smoke.py` reads); `test_manifest_is_current` regenerates both.

A seeded state_dict over a manifest then goes through both converters
(equal tensors) and through both fp32 eval forwards at the golden shape
(1x32x64, max_disp 32, 3 GRU levels, 2 iterations): within 1e-5 px plus
1e-5 of the disparity.  Both sides compute the same ops in fp32 and differ
only in the order of conv sums, an error that grows with the disparity and
the iterations: measured max 6.7e-6 px for IGEV (disparities to 18 px) and
1.05e-5 px for RAFT (disparities to 4.4 px); a wrong channel binding or tap
is off by whole pixels.
"""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from anystereo_tpu.config import CoreType as JaxCore
from anystereo_tpu.config import reference_regime_config as jax_reference_config
from anystereo_tpu.nn.model import AnyStereo as JaxAnyStereo
from anystereo_tpu.ops.lookup import internal_to_reference_perm as jax_perm
from anystereo_tpu.utils import torch_convert as jtc
from anystereo_tpu.utils.torch_compat import strip_module_prefix as jax_strip
from anystereo_tpu_torch.config import CoreType, reference_regime_config
from anystereo_tpu_torch.nn.model import AnyStereo
from anystereo_tpu_torch.ops.lookup import internal_to_reference_perm
from anystereo_tpu_torch.train.state import CHECKPOINT_FILE, restore_eval_variables
from anystereo_tpu_torch.utils import torch_compat
from anystereo_tpu_torch.utils.torch_convert import convert_state_dict
from anystereo_tpu_torch.utils.weights import from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
B, H, W, MAX_DISP, ITERS = 1, 32, 64, 32, 2
FP32_ATOL, FP32_RTOL = 1e-5, 1e-5  # px, and of the disparity
CORES = {"igev": dict(core=JaxCore.IGEV, corr_levels=2), "raft": dict(core=JaxCore.RAFT, corr_levels=4)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: a parallel test run shares the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# the manifest
# --------------------------------------------------------------------- #


def _flax_shapes(cfg):
    """{"params/a/b/kernel": shape, "batch_stats/...": shape} of the JAX init."""
    img = np.zeros((1, H, W, 3), np.float32)
    tree = jax.eval_shape(
        lambda: JaxAnyStereo(cfg).init(jax.random.PRNGKey(0), img, img, iters=1, mode="eval"))
    return {"/".join(p.key for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def reference_manifest(core: str):
    """[(key, shape, dtype)] of the reference state_dict that the JAX
    converter reads for `core` at `ModelConfig()` widths, in its order; and
    the flax leaves its primitives wrote, each once."""
    cfg = jax_reference_config(**CORES[core])
    flax = _flax_shapes(cfg)
    records, written = {}, []

    def shape(path):
        return flax[path]  # KeyError: the converter names a flax leaf the model lacks

    def has(path):
        return path in flax

    def rec(key, shp, dtype="float32"):
        assert key not in records, f"{key} named twice"
        records[key] = (tuple(int(s) for s in shp), dtype)

    def put(self, collection, path, shp):
        written.append(f"{collection}/{path}")
        jtc._put(self.params if collection == "params" else self.stats, path,
                 np.broadcast_to(np.float32(0), shp))

    class Used(set):
        """The keys the converter consumes without a primitive: their shapes
        follow from the tensors they alias."""

        def add(self, key):
            super().add(key)
            if key in records:
                return
            if key.endswith(".num_batches_tracked"):
                rec(key, (), "int64")
            elif ".norm3." in key:
                rec(key, records[key.replace(".norm3.", ".downsample.1.")][0])
            elif ".bn." in key:  # dead BatchNorm of BasicConv(bn=False): the deconv's O
                rec(key, (records[key.split(".bn.")[0] + ".conv.weight"][0][1],))
            else:
                raise AssertionError(f"unexpected consumed key {key}")

    def init(self, sd):
        self.sd, self.params, self.stats, self.used = {}, {}, {}, Used()

    def conv(self, dst, src, bias=None):
        k = shape(f"params/{dst}/kernel")
        rec(f"{src}.weight", (k[-1], k[-2]) + k[:-2])
        put(self, "params", f"{dst}/kernel", k)
        if bias or (bias is None and has(f"params/{dst}/bias")):
            rec(f"{src}.bias", shape(f"params/{dst}/bias"))
            put(self, "params", f"{dst}/bias", (k[-1],))

    def deconv(self, dst, src, zero_bias_features=None):
        k = shape(f"params/{dst}/kernel")
        rec(f"{src}.weight", (k[-2], k[-1]) + k[:-2])
        put(self, "params", f"{dst}/kernel", k)
        if has(f"params/{dst}/bias"):
            if zero_bias_features is None:
                rec(f"{src}.bias", shape(f"params/{dst}/bias"))
            put(self, "params", f"{dst}/bias", (k[-1],))

    def bn(self, dst, src):
        c = shape(f"params/{dst}/scale")
        for name in ("weight", "bias", "running_mean", "running_var"):
            rec(f"{src}.{name}", c)
        for path, stat in (("scale", "params"), ("bias", "params"), ("mean", "batch_stats"),
                           ("var", "batch_stats")):
            shape(f"{stat}/{dst}/{path}")
            put(self, stat, f"{dst}/{path}", c)
        self.used.add(f"{src}.num_batches_tracked")

    def layernorm2d(self, dst, src):
        for name, leaf in (("weight", "scale"), ("bias", "bias")):
            rec(f"{src}.{name}", shape(f"params/{dst}/{leaf}"))
            put(self, "params", f"{dst}/{leaf}", shape(f"params/{dst}/{leaf}"))

    def dense(self, dst, src):
        k = shape(f"params/{dst}/kernel")
        rec(f"{src}.weight", (k[1], k[0]))
        rec(f"{src}.bias", shape(f"params/{dst}/bias"))
        put(self, "params", f"{dst}/kernel", k)
        put(self, "params", f"{dst}/bias", (k[1],))

    real_block = jtc._Converter.residual_block

    def residual_block(self, dst, src):
        self.sd = dict.fromkeys(
            [k for k, there in ((f"{src}.norm1.weight", has(f"params/{dst}/FrozenBatchNorm_0/scale")),
                                (f"{src}.downsample.0.weight", has(f"params/{dst}/Conv_2/kernel")))
             if there])
        real_block(self, dst, src)

    with pytest.MonkeyPatch.context() as mp:
        for name, fn in (("__init__", init), ("conv", conv), ("deconv", deconv), ("bn", bn),
                         ("layernorm2d", layernorm2d), ("dense", dense),
                         ("residual_block", residual_block)):
            mp.setattr(jtc._Converter, name, fn)
        convert = jtc.convert_igev_state_dict if core == "igev" else jtc.convert_raft_state_dict
        convert({}, cfg)
    return [(k, list(s), d) for k, (s, d) in records.items()], written, flax


def _manifest_path(core):
    return os.path.join(DATA, f"reference_keys_{core}.json")


def load_manifest(core):
    with open(_manifest_path(core)) as f:
        return json.load(f)


def write_manifests():
    """Regenerate `tests/data/reference_keys_{igev,raft}.json`:
    `python -c "import tests.test_torch_convert as t; t.write_manifests()"`."""
    for core in CORES:
        keys, _, _ = reference_manifest(core)
        head = {"core": core, "config": f"reference_regime_config(core={CORES[core]['core'].value!r}, "
                                        f"corr_levels={CORES[core]['corr_levels']})"}
        with open(_manifest_path(core), "w") as f:  # one tensor a line
            f.write(json.dumps(head)[:-1] + ', "keys": [\n' + ",\n".join(json.dumps(k) for k in keys)
                    + "\n]}\n")


@pytest.mark.parametrize("core", list(CORES))
def test_manifest_is_current(core):
    """The committed manifest is what the JAX converter names today, and the
    converter's primitives write every flax leaf of the init exactly once."""
    keys, written, flax = reference_manifest(core)
    assert load_manifest(core)["keys"] == [list(k) for k in json.loads(json.dumps(keys))]
    assert sorted(written) == sorted(flax), sorted(set(flax) ^ set(written))[:10]


# --------------------------------------------------------------------- #
# seeded reference state_dicts
# --------------------------------------------------------------------- #


def seeded_state_dict(core, seed=11, prefix=""):
    """Reference-format tensors over the manifest: fan-in scaled weights,
    BatchNorm scales near 1 and variances in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)
    sd = {}
    for key, shape, dtype in load_manifest(core)["keys"]:
        if dtype == "int64":
            v = np.asarray(rng.randint(0, 1000), np.int64)
        elif key.endswith(".running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif key.endswith(".weight") and len(shape) >= 2:
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif key.endswith(".weight"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:
            v = 0.1 * rng.randn(*shape)
        sd[prefix + key] = torch.from_numpy(np.asarray(v, np.float32 if dtype == "float32" else np.int64))
    return sd


def _port_cfg(core, **kw):
    base = dict(core=CoreType(core), corr_levels=CORES[core]["corr_levels"], **kw)
    return reference_regime_config(**base)


def _jax_tree(core, sd, cfg):
    numpy_sd = {k: v.numpy() for k, v in sd.items()}
    convert = jtc.convert_igev_state_dict if core == "igev" else jtc.convert_raft_state_dict
    return convert(numpy_sd, cfg)


@pytest.fixture(scope="module", params=list(CORES))
def converted(request):
    core = request.param
    sd = seeded_state_dict(core)
    cfg = _port_cfg(core, max_disp=MAX_DISP, compute_dtype="float32")
    jcfg = jax_reference_config(**CORES[core], max_disp=MAX_DISP, compute_dtype="float32")
    return core, sd, cfg, jcfg, convert_state_dict(sd, cfg), _jax_tree(core, sd, jcfg)


def test_converter_matches_jax(converted):
    """The port's converter gives, tensor for tensor, what the JAX converter
    gives through `from_flax`; the result loads strictly."""
    core, _, cfg, _, got, tree = converted
    want = from_flax(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    AnyStereo(cfg).load_state_dict(got, strict=True)


def test_eval_forward_matches_jax(converted):
    """Both fp32 eval forwards, each with its own converted weights."""
    core, _, cfg, jcfg, sd, tree = converted
    rng = np.random.RandomState(42)
    left = (rng.rand(B, H, W, 3) * 255).astype(np.float32)
    right = (rng.rand(B, H, W, 3) * 255).astype(np.float32)
    jm = JaxAnyStereo(jcfg)
    want = jax.jit(lambda v, l, r: jm.apply(v, l, r, iters=ITERS, mode="eval"))(
        jax.tree_util.tree_map(np.asarray, tree), left, right)
    model = AnyStereo(cfg).eval()
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(left), torch.from_numpy(right), iters=ITERS)
    fields = ("init_disp", "disp_lowres", "disp_final") if core == "igev" else ("disp_lowres", "disp_final")
    for field in fields:
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=FP32_RTOL, atol=FP32_ATOL, err_msg=f"{core} {field}")


@pytest.mark.parametrize("levels,radius,groups", [(2, 4, 8), (1, 4, 8), (4, 4, None), (3, 2, 4),
                                                  (2, 1, 1)])
def test_internal_to_reference_perm(levels, radius, groups):
    got = internal_to_reference_perm(levels, radius, groups)
    np.testing.assert_array_equal(got, jax_perm(levels, radius, groups))
    assert sorted(got) == list(range(len(got)))


def test_layout_helpers_match_jax():
    from anystereo_tpu.utils import torch_compat as jcompat

    rng = np.random.RandomState(0)
    for w in (rng.randn(5, 3, 3, 3), rng.randn(4, 2, 3, 3, 3), rng.randn(6, 7)):
        for fn in ("conv_kernel", "conv_transpose_kernel", "dense_kernel"):
            np.testing.assert_array_equal(getattr(torch_compat, fn)(w), getattr(jcompat, fn)(w))
    sd = {"module.a.weight": rng.randn(3), "module.a.bias": rng.randn(3), "b.running_mean": rng.randn(3),
          "b.running_var": rng.randn(3), "b.weight": rng.randn(3), "b.bias": rng.randn(3)}
    assert torch_compat.strip_module_prefix(sd).keys() == jax_strip(sd).keys()
    got, want = torch_compat.frozen_bn("b", sd), jcompat.frozen_bn("b", sd)
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and all(np.array_equal(g[k], w[k]) for k in g)


def test_prefix_wrapper_extra_and_missing_keys():
    """A `module.` prefix and a `{"model": ...}` wrapper are accepted; an
    extra tensor raises `ValueError`, a missing one `KeyError`."""
    cfg = _port_cfg("raft")
    plain = convert_state_dict(seeded_state_dict("raft"), cfg)
    wrapped = convert_state_dict({"model": seeded_state_dict("raft", prefix="module.")}, cfg)
    assert all(torch.equal(plain[k], wrapped[k]) for k in plain)
    extra = seeded_state_dict("raft")
    extra["fnet.extra.weight"] = torch.zeros(3)
    with pytest.raises(ValueError, match="unconverted reference tensors"):
        convert_state_dict(extra, cfg)
    missing = seeded_state_dict("raft")
    del missing["update_block.gru08.convz.weight"]
    with pytest.raises(KeyError):
        convert_state_dict(missing, cfg)
    with pytest.raises(ValueError, match="three GRU levels"):
        convert_state_dict(seeded_state_dict("igev"), _port_cfg("igev", n_gru_layers=2))


def test_tool_output_restores(tmp_path, caplog):
    """`python -m anystereo_tpu_torch.tools.convert_checkpoint` writes step 0
    in the layout of `train/state.py`; `restore_eval_variables` finds every
    buffer in it, and the weights are the converter's."""
    sd = seeded_state_dict("igev", prefix="module.")
    ref = tmp_path / "ref.pth"
    torch.save({"model": sd}, ref)
    out = tmp_path / "ckpt"
    proc = subprocess.run(
        [sys.executable, "-m", "anystereo_tpu_torch.tools.convert_checkpoint", "--torch-ckpt", str(ref),
         "--out", str(out), "--max-disp", str(MAX_DISP), "--device", "cpu", "--verify"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "verify: forward finite OK" in proc.stdout
    saved = torch.load(out / "0" / CHECKPOINT_FILE, weights_only=True)
    assert saved["step"] == 0 and "optimizer" not in saved
    cfg = _port_cfg("igev", max_disp=MAX_DISP)
    model = AnyStereo(cfg)
    with caplog.at_level(logging.WARNING):
        restore_eval_variables(str(out), model)
    assert not [r for r in caplog.records if "has no" in r.getMessage() or "fit no" in r.getMessage()]
    want = convert_state_dict(sd, cfg)
    got = model.state_dict()
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_converted_checkpoint_in_a_groupnorm_model_warns(tmp_path, caplog):
    """The CLI builds the GroupNorm model: a converted checkpoint's
    BatchNorm tensors fit none of its parameters, and
    `restore_eval_variables` says so instead of dropping them silently."""
    from anystereo_tpu_torch.config import ModelConfig
    from anystereo_tpu_torch.tools.convert_checkpoint import write_weights

    write_weights(str(tmp_path / "w"), convert_state_dict(seeded_state_dict("igev"), _port_cfg("igev")))
    model = AnyStereo(ModelConfig(max_disp=MAX_DISP))
    with caplog.at_level(logging.WARNING):
        restore_eval_variables(str(tmp_path / "w"), model)
    (msg,) = [r.getMessage() for r in caplog.records if "fit no" in r.getMessage()]
    assert "running_mean" in msg and "reference_regime_config" in msg


def test_weights_only_checkpoint_restores_weights_and_refuses_a_resume(tmp_path):
    """A converted checkpoint has no optimizer state: `restore_checkpoint`
    (a resume) raises and names the warm start; `restore_params_only` reads
    its weights."""
    from anystereo_tpu_torch.config import TrainConfig
    from anystereo_tpu_torch.nn.model import build_model
    from anystereo_tpu_torch.tools.convert_checkpoint import write_weights
    from anystereo_tpu_torch.train.state import create_train_state, restore_checkpoint, restore_params_only

    cfg = _port_cfg("igev", max_disp=MAX_DISP, hidden_dims=(32, 32, 32))
    donor = build_model(cfg, "cpu", seed=3)
    write_weights(str(tmp_path / "w"), donor.state_dict())
    with pytest.raises(FileExistsError):
        write_weights(str(tmp_path / "w"), donor.state_dict())
    state = create_train_state(build_model(cfg, "cpu", seed=4), TrainConfig(), "cpu")
    with pytest.raises(ValueError, match="weights-only.*warm start"):
        restore_checkpoint(str(tmp_path / "w"), state)
    got = restore_params_only(str(tmp_path / "w"), dict(state.model.named_parameters()))
    assert all(torch.equal(got[k], p) for k, p in donor.named_parameters())
