"""The port's bench entry point (`anystereo_tpu_torch/bench.py`, `cli.py
bench`) on the CPU, against the JAX package's forward.

Shape of `tests/test_torch_model.py`: 1x32x64, max_disp 32, 2 GRU
iterations, fp32, eval mode, dense decode; the flax variables are made from
a numpy seed over the tree `init` would build (`jax.eval_shape`) and carried
over with `from_flax`.  The images are the bench's own
(`np.random.RandomState(0)`).  `run` at k = 3, one rep, one synchronised
forward returns every key of the line; a hook on the model sees its
forwards, 1 + n_rep + (1 + k)(1 + reps) of them, so the direct forward and
the chain's first forward (carry 0) are each within 1e-3 px of the JAX
model's `disp_final` (both sides fp32, sums in other orders: measured max
1e-5 px in `tests/test_torch_model.py`).  The JAX side is one jitted forward;
JAX's own `pipelined_per_call` is not compiled on the model.

`cli.main(["bench", "--device", "cpu"])` with the module's protocol
constants and `ANYSTEREO_BENCH_OVERRIDES` set to that shape prints one JSON
line; without a card and without `--device cpu` the bench raises, in the
process and as `python -m anystereo_tpu_torch.bench`.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anystereo_tpu.config import ModelConfig as JaxConfig
from anystereo_tpu.nn.model import AnyStereo as JaxAnyStereo
from anystereo_tpu_torch import bench, cli
from anystereo_tpu_torch.config import ModelConfig
from anystereo_tpu_torch.nn.model import AnyStereo
from anystereo_tpu_torch.utils import profiling
from anystereo_tpu_torch.utils.weights import from_flax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_model import _seeded_variables  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W, MAX_DISP, ITERS = 1, 32, 64, 32, 2
K, REPS, N_REP = 3, 1, 1
ATOL = 1e-3  # px, fp32 against the JAX forward
SMALL = {"max_disp": MAX_DISP, "compute_dtype": "float32"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: a parallel test run shares the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bench_images():
    """The images `bench.run` makes, in its order."""
    rng = np.random.RandomState(0)
    return tuple(rng.rand(B, H, W, 3).astype(np.float32) * 255 for _ in range(2))


@pytest.fixture(scope="module")
def jax_weights_and_disp():
    left, right = _bench_images()
    jm = JaxAnyStereo(JaxConfig(**SMALL))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), left, right, iters=1, mode="eval"))
    variables = _seeded_variables(shapes)
    disp = jax.jit(lambda v, l, r: jm.apply(v, l, r, iters=ITERS, mode="eval").disp_final)(
        variables, jnp.asarray(left), jnp.asarray(right))
    return variables, np.asarray(disp)


@pytest.fixture(scope="module")
def bench_run(jax_weights_and_disp):
    """`run` on a model carrying the JAX weights; (line, every forward's
    disp_final in order)."""
    variables, _ = jax_weights_and_disp
    model = AnyStereo(ModelConfig(**SMALL))
    model.load_state_dict(from_flax(variables), strict=True)
    model.eval()
    seen = []
    hook = model.register_forward_hook(lambda m, args, out: seen.append(out.disp_final.clone()))
    try:
        line = bench.run(ModelConfig(**SMALL), b=B, h=H, w=W, iters=ITERS, device="cpu", k=K, reps=REPS,
                         n_rep=N_REP, model=model)
    finally:
        hook.remove()
    return line, seen


def test_run_returns_every_key_of_the_line(bench_run):
    line, _ = bench_run
    assert tuple(line) == bench.LINE_KEYS
    assert line["metric"] == "stereo_pairs_per_sec" and line["unit"] == "pairs/s"
    assert line["config"] == f"IGEV eval {H}x{W} iters={ITERS} maxdisp={MAX_DISP} fp32, pipelined"
    assert line["device"] == "cpu" and line["build_s"] == 0.0  # nothing to build on the CPU
    # `value` and the ratios are each rounded to 3 places from the unrounded
    # rate, so the ratio of the rounded value may differ by one in the last place
    for key, base in (("vs_baseline", bench.BASELINE_PAIRS_PER_SEC),
                      ("vs_baseline_a100", bench.A100_BASELINE_PAIRS_PER_SEC)):
        assert abs(line[key] - line["value"] / base) <= 5e-4 + 5e-4 / base + 1e-12, key
    assert json.loads(json.dumps(line)) == line


def test_run_makes_the_forwards_it_says(bench_run):
    _, seen = bench_run
    assert len(seen) == 1 + N_REP + (1 + K) * (1 + REPS)


@pytest.mark.parametrize("which", ["direct", "first_chained"])
def test_run_outputs_match_jax(bench_run, jax_weights_and_disp, which):
    _, seen = bench_run
    _, want = jax_weights_and_disp
    got = seen[0] if which == "direct" else seen[1 + N_REP]
    assert tuple(got.shape) == want.shape == (B, H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_run_raises_when_the_chain_diverges(monkeypatch):
    """A chained output off the direct one by more than the band raises,
    whatever time it would post."""
    def off_by_one_px(apply_fn, args, k, reps):
        out = apply_fn(torch.zeros(()), *args)
        return 1.0, {"t1": 1.0, "tk": 1.0, "compile_s": 1.0, "first_out": out + 1.0}

    monkeypatch.setattr(profiling, "pipelined_per_call", off_by_one_px)
    model = AnyStereo(ModelConfig(**SMALL)).eval()
    with pytest.raises(RuntimeError, match="diverges from the direct forward"):
        bench.run(ModelConfig(**SMALL), b=B, h=H, w=W, iters=1, device="cpu", k=2, reps=1, n_rep=1, model=model)


def test_cli_bench_prints_one_json_line(monkeypatch, capsys):
    for name, value in {"H": H, "W": W, "ITERS": ITERS, "K": 2, "REPS": 1, "N_REP": 1}.items():
        monkeypatch.setattr(bench, name, value)
    monkeypatch.setenv("ANYSTEREO_BENCH_OVERRIDES", json.dumps(SMALL))
    assert cli.main(["bench", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert tuple(line) == bench.LINE_KEYS and line["device"] == "cpu"
    assert line["config"].endswith(f", pipelined overrides={SMALL}")
    assert np.isfinite(line["latency_ms_e2e"]) and line["latency_ms_e2e"] > 0


def test_without_a_card_the_bench_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def test_python_m_bench_exits_non_zero_without_a_card():
    proc = subprocess.run([sys.executable, "-m", "anystereo_tpu_torch.bench"], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert proc.stdout == ""
