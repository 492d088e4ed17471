"""Checkpoint files of the PyTorch port (`train/state.py`): the full state
round trip, the numbered step directories and their pruning, the
weight-only merge of a warm start and the evaluator's restore.

Everything here is exact: a restore copies the saved tensors bit for bit.
The models are the IGEV model at `max_disp` 32 with narrow GRUs (one level
of 32 channels) and frozen BatchNorm in the 2-D convs, so the state carries
BatchNorm statistics as buffers; no forward is run.  Optimizer states come
from updates with seeded gradients.
"""

import logging
import os

import numpy as np
import pytest
import torch

from anystereo_tpu_torch.config import ModelConfig, NormType, TrainConfig
from anystereo_tpu_torch.nn.model import build_model
from anystereo_tpu_torch.train import state as ts

CFG = ModelConfig(max_disp=32, compute_dtype="float32", hidden_dims=(32, 32, 32), n_gru_layers=1,
                  norm_2d=NormType.FROZEN_BATCH)
TCFG = TrainConfig(lr=1e-3, num_steps=50)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: a parallel test run puts
    several test processes on the same cores, and oversubscribed thread
    pools slow these steps several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _trained_state(seed, updates=3, cfg=CFG):
    """A state after `updates` AdamW updates with seeded gradients, its
    BatchNorm statistics and skip counters set to values no fresh state
    has."""
    state = ts.create_train_state(build_model(cfg, "cpu", seed=seed), TCFG, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in state.model.named_buffers():
            if "running" in name:
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    for _ in range(updates):
        for p in state.model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        state.optimizer.step()
        state.step += 1
    state.optimizer.notfinite_count, state.optimizer.total_notfinite = 0, 2
    state.step += 2  # two skipped steps
    return state


def _snapshot(state):
    return dict(
        model={k: v.clone() for k, v in state.model.state_dict().items()},
        mu=[m.clone() for m in state.optimizer.mu], nu=[m.clone() for m in state.optimizer.nu],
        count=state.optimizer.count, notfinite=state.optimizer.notfinite_count,
        total=state.optimizer.total_notfinite, step=state.step)


def _assert_same(got, want):
    assert set(got["model"]) == set(want["model"])
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for a, b in zip(got["mu"] + got["nu"], want["mu"] + want["nu"]):
        assert torch.equal(a, b)
    for k in ("count", "notfinite", "total", "step"):
        assert got[k] == want[k], k


def test_save_restore_is_exact(tmp_path):
    state = _trained_state(seed=1)
    assert any("running_mean" in k for k, _ in state.model.named_buffers())
    want = _snapshot(state)
    path = ts.save_checkpoint(str(tmp_path), state)
    assert path == os.path.join(str(tmp_path), "5", ts.CHECKPOINT_FILE)
    fresh = ts.create_train_state(build_model(CFG, "cpu", seed=2), TCFG, device="cpu")
    ts.restore_checkpoint(str(tmp_path), fresh)
    _assert_same(_snapshot(fresh), want)
    # the restored state takes the same next update as the saved one
    gen = torch.Generator().manual_seed(9)
    grads = [torch.randn(p.shape, generator=gen) for p in state.model.parameters()]
    for s in (state, fresh):
        for p, g in zip(s.model.parameters(), grads):
            p.grad = g.clone()
        s.optimizer.step()
    _assert_same(_snapshot(fresh), _snapshot(state))


def test_steps_keep_five_and_restore_a_given_step(tmp_path):
    state = _trained_state(seed=3, updates=1)
    saved = {}
    for step in range(1, 8):
        state.step = step
        with torch.no_grad():
            next(state.model.parameters()).add_(1.0)
        saved[step] = _snapshot(state)
        ts.save_checkpoint(str(tmp_path), state)
    assert ts.checkpoint_steps(str(tmp_path)) == [3, 4, 5, 6, 7]
    assert ts.latest_step(str(tmp_path)) == 7
    assert sorted(os.listdir(tmp_path)) == ["3", "4", "5", "6", "7"]  # no temporary left
    with pytest.raises(FileExistsError):
        ts.save_checkpoint(str(tmp_path), state)
    fresh = ts.create_train_state(build_model(CFG, "cpu", seed=4), TCFG, device="cpu")
    _assert_same(_snapshot(ts.restore_checkpoint(str(tmp_path), fresh, step=4)), saved[4])
    _assert_same(_snapshot(ts.restore_checkpoint(str(tmp_path), fresh)), saved[7])
    assert ts.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ts.restore_checkpoint(str(tmp_path / "none"), fresh)


def test_restore_params_only_merges_by_name_and_shape(tmp_path):
    donor = _trained_state(seed=5)
    ts.save_checkpoint(str(tmp_path), donor)
    # another configuration: the context GRU is narrower, so some shapes
    # differ, and the 2-D norms are GroupNorm (other names)
    other = ModelConfig(max_disp=32, compute_dtype="float32", hidden_dims=(64, 64, 64), n_gru_layers=1)
    model = build_model(other, "cpu", seed=6)
    params = dict(model.named_parameters())
    merged = ts.restore_params_only(str(tmp_path), params)
    assert set(merged) == set(params)
    donor_sd = donor.model.state_dict()
    loaded = kept = 0
    for name, value in merged.items():
        d = donor_sd.get(name)
        if d is not None and d.shape == params[name].shape:
            assert torch.equal(value, d) and value.dtype == params[name].dtype
            loaded += 1
        else:
            assert value is params[name]
            kept += 1
    assert loaded > 0 and kept > 0, (loaded, kept)


def test_restore_eval_variables(tmp_path, caplog):
    donor = _trained_state(seed=7)
    ts.save_checkpoint(str(tmp_path / "bn"), donor)
    model = ts.restore_eval_variables(str(tmp_path / "bn"), build_model(CFG, "cpu", seed=8))
    for k, v in donor.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    # a checkpoint without BatchNorm statistics: the parameters it has load,
    # the statistics keep their values, with a warning
    gn = ModelConfig(max_disp=32, compute_dtype="float32", hidden_dims=(32, 32, 32), n_gru_layers=1)
    plain = ts.create_train_state(build_model(gn, "cpu", seed=9), TCFG, device="cpu")
    ts.save_checkpoint(str(tmp_path / "gn"), plain)
    target = build_model(CFG, "cpu", seed=10)
    before = {k: v.clone() for k, v in target.named_buffers()}
    with caplog.at_level(logging.WARNING, logger="anystereo_tpu_torch.train.state"):
        ts.restore_eval_variables(str(tmp_path / "gn"), target)
    assert "running_mean" in caplog.text
    for k, v in target.named_buffers():
        if "running" in k:
            assert torch.equal(v, before[k]), k
    shared = [n for n, p in target.named_parameters()
              if n in dict(plain.model.named_parameters())
              and p.shape == dict(plain.model.named_parameters())[n].shape]
    assert shared and all(torch.equal(dict(target.named_parameters())[n],
                                      dict(plain.model.named_parameters())[n]) for n in shared)


def test_checkpoint_holds_no_device_tensors(tmp_path):
    """Tensors are saved from the host, so a checkpoint restores onto any
    device (the card's restore is exercised by `chip_smoke.py`)."""
    state = _trained_state(seed=11, updates=1)
    path = ts.save_checkpoint(str(tmp_path), state)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    tensors = list(ckpt["model"].values()) + list(ckpt["optimizer"]["mu"].values())
    assert all(t.device.type == "cpu" for t in tensors)
    assert set(ckpt["optimizer"]["mu"]) == {n for n, _ in state.model.named_parameters()}
    np.testing.assert_array_equal(ckpt["step"], state.step)
