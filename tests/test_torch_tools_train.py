"""The port's tools (`python -m anystereo_tpu_torch.tools.<name>`) that train run
on the CPU, each in a subprocess where `cv2` and `PIL` cannot be imported
(the card's host has neither) and torch holds two intra-op threads: the
end-to-end demo, the overfit sanity check, the baseline rehearsal from a
checkpoint of `train/state.py` and the scaling bench over two gloo ranks
(`tests/test_torch_tools_data.py` runs the tree writer and the dataset
gate).  A few steps each: that the control flow and the files are right,
not that a model learns (that runs on the card: `chip_smoke.py`'s `tools`
phase)."""

import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from anystereo_tpu_torch.config import ModelConfig, TrainConfig
from anystereo_tpu_torch.nn.model import build_model
from anystereo_tpu_torch.tools import make_synthetic_datasets as synth
from anystereo_tpu_torch.train.state import create_train_state, save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: a parallel test run puts
    several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tool(name, *args, timeout=240):
    """`anystereo_tpu_torch.tools.<name>.main(args)` in a fresh interpreter
    with cv2 and PIL blocked; the process's rc, stdout and stderr.  It also
    fails if the tool loaded the JAX stack or the JAX package."""
    code = ("import sys, torch\n"
            "sys.modules['cv2'] = sys.modules['PIL'] = None\n"
            "torch.set_num_threads(2)\n"
            f"from anystereo_tpu_torch.tools import {name} as tool\n"
            f"rc = tool.main({[str(a) for a in args]!r})\n"
            "bad = [m for m in ('jax', 'flax', 'anystereo_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n"
            "sys.exit(rc)\n")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=timeout, env={**os.environ, "PYTHONPATH": REPO})


def test_e2e_demo_two_steps(tmp_path):
    out = _tool("e2e_demo", "--steps", 2, "--pairs", 2, "--device", "cpu", "--out", tmp_path)
    assert out.returncode in (0, 1), out.stderr[-3000:]
    epe = float(re.search(r"^E2E (?:PASS|WEAK) epe=(\S+)$", out.stdout, re.M).group(1))
    assert math.isfinite(epe)
    report = tmp_path / "report"
    with open(report / "result.txt") as f:
        assert "summary" in f.read()
    assert len([f for f in os.listdir(report / "output") if f.endswith(".png")]) == 2 * 4
    assert os.listdir(tmp_path / "ckpt") == ["2"]


def test_e2e_demo_trains_deterministically_and_restores_the_setting(tmp_path, monkeypatch):
    """The demo's run repeats from its seed: it trains under PyTorch's
    deterministic algorithms (the scatter-add's sorted kernel on the card),
    and the caller's setting comes back after it, also when the run raises."""
    from anystereo_tpu_torch.tools import e2e_demo
    from anystereo_tpu_torch.train import trainer

    class Stop(Exception):
        pass

    seen = []

    def train(cfg, loader, device=None):
        seen.append(torch.are_deterministic_algorithms_enabled())
        raise Stop

    monkeypatch.setattr(trainer, "train", train)
    assert not torch.are_deterministic_algorithms_enabled()
    with pytest.raises(Stop):
        e2e_demo.main(["--steps", "1", "--pairs", "1", "--device", "cpu", "--out", str(tmp_path)])
    assert seen == [True]
    assert not torch.are_deterministic_algorithms_enabled()


def test_overfit_sanity_two_steps():
    out = _tool("overfit_sanity", "--steps", 2, "--device", "cpu")
    assert out.returncode in (0, 1), out.stderr[-3000:]
    assert len(re.findall(r"^step +\d+ +loss", out.stdout, re.M)) == 2
    verdict = re.search(r"^(LEARNED|NOT_LEARNED) final epe (\S+)$", out.stdout, re.M)
    assert math.isfinite(float(verdict.group(2))) and (verdict.group(1) == "LEARNED") == (out.returncode == 0)


def test_reproduce_baseline_from_a_checkpoint(tmp_path):
    tree = str(tmp_path / "tree")
    rng = np.random.RandomState(0)
    synth.gen_kitti15(tree, rng, n=1)
    synth.gen_eth3d(tree, rng, scenes=("playground_1l",))
    cfg = ModelConfig(max_disp=192, corr_levels=2, corr_radius=4)
    save_checkpoint(str(tmp_path / "ckpt"), create_train_state(build_model(cfg, "cpu", seed=0), TrainConfig(), "cpu"))
    table = tmp_path / "measured.md"
    out = _tool("reproduce_baseline", "--data-root", tree, "--ckpt", tmp_path / "ckpt", "--skip-train",
                "--datasets", "kitti15", "eth3d", "--max-images", 1, "--valid-iters", 2, "--device", "cpu",
                "--out", table)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(table) as f:
        rows = [line for line in f.read().splitlines() if line.startswith("| ") and "epe=" in line]
    assert [r.split(" | ")[0] for r in rows] == ["| KITTI-2015 D1-all", "| ETH3D EPE/D1"]
    for r in rows:
        cells = r.split(" | ")
        assert cells[2] == "cpu", r
        assert math.isfinite(float(re.search(r"epe=(\S+?),", cells[1]).group(1)))


def test_scaling_bench_two_gloo_ranks():
    out = _tool("scaling_bench", "--devices", 1, 2, "--device", "cpu", "--steps", 1, "--iters", 1)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = re.findall(r"^devices (\d): +([\d.]+) ms/step +([\d.]+) samples/s +([\d.]+)/device +"
                       r"efficiency +([\d.]+)%$", out.stdout, re.M)
    assert [n for n, *_ in lines] == ["1", "2"], out.stdout
    (_, ms1, *_), (_, ms2, rate2, per2, eff2) = lines
    assert float(lines[0][4]) == 100.0
    np.testing.assert_allclose(float(eff2), 100 * float(ms1) / float(ms2), rtol=2e-2, atol=0.1)
    np.testing.assert_allclose(float(rate2), 2 * float(per2), rtol=2e-2, atol=0.02)
