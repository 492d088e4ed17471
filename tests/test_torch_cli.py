"""The command line of the PyTorch port (`anystereo_tpu_torch/cli.py`)
against the JAX package's (`anystereo_tpu/cli.py`).

`python -m anystereo_tpu_torch.cli train --device cpu` runs as a subprocess
for two steps on the synthetic SceneFlow tree of
`tools/make_synthetic_datasets.py` at the golden shape (32x64 crops,
max_disp 32, three GRU levels; the model at its default widths), warm
started from a converted reference checkpoint; `evaluate` then reads its
checkpoint.  The flag set, defaults and help are the JAX CLI's plus
`--device` (captured from the JAX parsers without running them); `train
--loader grain` runs two steps and writes its loader's state beside the
checkpoint (`bench` runs: `tests/test_torch_bench.py`); without
`--device` and without a card both subcommands raise instead of running on
the CPU; a weights-only checkpoint given as `--ckpt-dir` raises with a
message that names `--restore`.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from anystereo_tpu import cli as jax_cli
from anystereo_tpu_torch import cli
from anystereo_tpu_torch.config import reference_regime_config
from anystereo_tpu_torch.tools.convert_checkpoint import write_weights
from anystereo_tpu_torch.train import state as ts
from anystereo_tpu_torch.utils.torch_convert import convert_state_dict

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_convert import seeded_state_dict  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

GOLDEN = ["--max-disp", "32", "--n-gru-layers", "3"]
# the port's help differs from the JAX package's where the JAX help names
# what only the JAX package has
OWN_HELP = {"restore", "multihost", "device"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: a parallel test run shares the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    import make_synthetic_datasets as synth

    root = str(tmp_path_factory.mktemp("data"))
    synth.gen_sceneflow(root, np.random.RandomState(0), n_train=2, n_test=2, h=48, w=96)
    return root


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ref") / "ckpt")
    write_weights(out, convert_state_dict(seeded_state_dict("igev"), reference_regime_config()))
    return out


def _run(*args):
    return subprocess.run([sys.executable, "-m", "anystereo_tpu_torch.cli", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "OMP_NUM_THREADS": "2"})


@pytest.fixture(scope="module")
def trained(tree, converted, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("train") / "ckpt")
    proc = _run("train", "--datasets", "sceneflow", "--data-root", tree, "--inp-size", "32", "64",
                "--scale-max", "1.4", "--batch-size", "1", "--num-steps", "2", "--train-iters", "1",
                "--num-workers", "2", "--ckpt-dir", ckpt, "--restore", converted, "--device", "cpu", *GOLDEN)
    return proc, ckpt


def test_train_then_evaluate_on_the_cpu(trained, tree):
    proc, ckpt = trained
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "warm-started weights from" in proc.stderr
    assert ts.checkpoint_steps(ckpt) == [2]
    ev = _run("evaluate", "--dataset", "sceneflow", "--data-root", tree, "--ckpt", ckpt, "--valid-iters", "1",
              "--device", "cpu", *GOLDEN)
    assert ev.returncode == 0, ev.stderr[-3000:]
    lines = [ln for ln in ev.stdout.splitlines() if ": " in ln]
    names = [ln.split(": ")[0] for ln in lines]
    assert names == sorted(names) and "epe" in names and "d1" in names
    assert all(np.isfinite(float(ln.split(": ")[1])) for ln in lines)


def _actions(parser):
    return {a.dest: a for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def _jax_parser(monkeypatch, cmd):
    """The parser a JAX subcommand builds, taken at its parse_args."""

    class Taken(Exception):
        pass

    seen = []

    def take(self, *a, **kw):
        seen.append(self)
        raise Taken

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", take)
    with pytest.raises(Taken):
        cmd([])
    monkeypatch.undo()
    return seen[0]


@pytest.mark.parametrize("name", ["train", "evaluate"])
def test_flags_are_the_jax_clis_plus_device(monkeypatch, name):
    jax_cmd = jax_cli.cmd_train if name == "train" else jax_cli.cmd_evaluate
    want = _actions(_jax_parser(monkeypatch, jax_cmd))
    got = _actions(cli.train_parser() if name == "train" else cli.evaluate_parser())
    assert sorted(got) == sorted(list(want) + ["device"])
    assert got["device"].default == "cuda" and got["device"].option_strings == ["--device"]
    for dest, w in want.items():
        g = got[dest]
        for attr in ("option_strings", "default", "choices", "nargs", "type", "required", "const"):
            assert getattr(g, attr) == getattr(w, attr), (dest, attr)
        assert type(g) is type(w), dest
        if dest not in OWN_HELP:
            assert g.help == w.help, dest


def test_train_with_the_grain_loader_writes_its_state(tree, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    proc = _run("train", "--loader", "grain", "--datasets", "sceneflow", "--data-root", tree, "--inp-size", "32",
                "64", "--scale-max", "1.4", "--batch-size", "1", "--num-steps", "2", "--train-iters", "1",
                "--num-workers", "2", "--ckpt-dir", ckpt, "--device", "cpu", *GOLDEN)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert ts.checkpoint_steps(ckpt) == [2]
    with open(os.path.join(ckpt, "loader_state-2-p0.bin"), "rb") as f:
        state = json.loads(f.read())
    # two workers, one batch each so far: the sampler indices of their records
    assert state == {"last_seen_indices": {"0": 0, "1": 1}, "last_worker_index": 1, "worker_count": 2}


def test_refusals(capsys):
    assert cli.main(["nope"]) == 2 and "usage" in capsys.readouterr().out
    assert cli.main([]) == 2


def test_without_device_and_card_the_commands_raise(monkeypatch, tree, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--data-root", tree, "--inp-size", "32", "64", "--scale-max", "1.4",
                  "--num-steps", "1", "--ckpt-dir", str(tmp_path / "ck"), *GOLDEN])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["evaluate", "--data-root", tree, "--ckpt", str(tmp_path / "ck"), *GOLDEN])
    assert not os.path.exists(tmp_path / "ck")


def test_a_weights_only_checkpoint_is_no_resume(tree, converted):
    """Resuming from a converted checkpoint (`--ckpt-dir`) raises and says
    that it belongs in `--restore`."""
    with pytest.raises(ValueError, match="weights-only.*--restore"):
        cli.main(["train", "--data-root", tree, "--inp-size", "32", "64", "--scale-max", "1.4",
                  "--batch-size", "1", "--num-steps", "1", "--train-iters", "1", "--num-workers", "1",
                  "--ckpt-dir", converted, "--device", "cpu", *GOLDEN])
