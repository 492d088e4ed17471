"""The training entry point of the PyTorch port (`train/trainer.py`):
checkpoints and in-training validation, auto-resume, warm start and its two
refusals, the emergency checkpoint that replays a failed batch, the
divergence abort, SIGTERM, the exactly-once data order of a checkpointable
iterator across a resume, and the whole path from dataset files (the
synthetic SceneFlow tree) through the loader, `train()`, a checkpoint and
`run_validation` by dataset name.

The model is the IGEV model at `max_disp` 32 with narrow GRUs (one level of
32 channels), fp32, 1 GRU iteration, on 32x64 batches of 256 queries, so a
step takes a fraction of a second on the CPU.  Everything is compared
exactly: a resumed run against a straight one, a restored state against
the saved one, the CPU run being deterministic.
"""

import glob
import logging
import os
import signal
import sys

import numpy as np
import pytest
import torch

from anystereo_tpu_torch.config import Config, MeshConfig, ModelConfig, TrainConfig
from anystereo_tpu_torch.data.augment import AugmentorConfig
from anystereo_tpu_torch.data.datasets import fetch_dataset
from anystereo_tpu_torch.data.loader import PrefetchLoader
from anystereo_tpu_torch.eval.validate import make_train_validate_fn, run_validation
from anystereo_tpu_torch.nn.model import build_model
from anystereo_tpu_torch.train import state as ts
from anystereo_tpu_torch.train import trainer as tr

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

B, H, W, Q = 1, 32, 64, 256
MODEL = ModelConfig(max_disp=32, compute_dtype="float32", hidden_dims=(32, 32, 32), n_gru_layers=1)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: a parallel test run puts
    several test processes on the same cores, and oversubscribed thread
    pools slow these steps several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(ckpt_dir, steps=100, **kw):
    return Config(model=MODEL, train=TrainConfig(
        train_iters=1, batch_size=B, num_steps=steps, ckpt_every=kw.pop("ckpt_every", 1000),
        ckpt_dir=str(ckpt_dir), inp_size=(H, W), **kw))


def _batch(seed, poison=False):
    rng = np.random.RandomState(seed)
    left = (rng.rand(B, H, W, 3) * 255).astype(np.float32)
    return {
        "left": np.full_like(left, np.nan) if poison else left,
        "right": np.roll(left, -3, axis=2),
        "coords": (rng.rand(B, Q, 2) * 2 - 1).astype(np.float32),
        "gt": np.full((B, Q), 3.0, np.float32),
        "valid": np.ones((B, Q), np.float32),
        "scale": np.ones(B, np.float32),
        "gt_low": np.full((B, H // 4, W // 4), 0.75, np.float32),
    }


class _Served:
    """A checkpointable iterator over seeded batches: `get_state` /
    `set_state` carry the index of the next batch; `served` records every
    index handed out."""

    def __init__(self, served):
        self.i, self.served = 0, served

    def __iter__(self):
        return self

    def __next__(self):
        self.served.append(self.i)
        self.i += 1
        return _batch(self.i - 1)

    def get_state(self):
        return str(self.i).encode()

    def set_state(self, s):
        self.i = int(s)


class _Loader:
    def __init__(self, served=None):
        self.served = [] if served is None else served

    def __iter__(self):
        return _Served(self.served)


@pytest.fixture
def recorded(monkeypatch):
    """The metrics of every step `train()` takes, in order."""
    seen = []
    real = tr.MetricLogger.push

    def push(self, step, metrics):
        seen.append((step, {k: float(v) for k, v in metrics.items()}))
        real(self, step, metrics)

    monkeypatch.setattr(tr.MetricLogger, "push", push)
    return seen


def _params(state):
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def _same(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_train_checkpoints_and_validates(tmp_path, recorded):
    calls = []

    def validate_fn(state, step):
        calls.append((step, state.step))
        return {"epe": 1.0}

    state = tr.train(_cfg(tmp_path / "ck", ckpt_every=2), _Loader(), validate_fn, max_steps=3,
                     device="cpu")
    assert state.step == 3 and calls == [(2, 2), (3, 3)]
    assert ts.checkpoint_steps(str(tmp_path / "ck")) == [2, 3]
    assert [s for s, _ in recorded] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) and m["nonfinite_skips"] == 0 for _, m in recorded)
    assert recorded[0][1]["lr"] == pytest.approx(2e-4 / 25)
    fresh = ts.create_train_state(build_model(MODEL, "cpu", seed=5), _cfg("x").train, "cpu")
    assert _same(_params(ts.restore_checkpoint(str(tmp_path / "ck"), fresh)), _params(state))


def test_auto_resume_continues_the_schedule_exactly(tmp_path, recorded):
    straight = tr.train(_cfg(tmp_path / "a"), _Loader(), max_steps=4, device="cpu")
    lrs = [m["lr"] for _, m in recorded]
    recorded.clear()
    tr.train(_cfg(tmp_path / "b", ckpt_every=2), _Loader(), max_steps=2, device="cpu")
    recorded.clear()
    resumed = tr.train(_cfg(tmp_path / "b", ckpt_every=2), _Loader(), max_steps=4, device="cpu")
    assert resumed.step == 4 and [s for s, _ in recorded] == [2, 3]
    assert [m["lr"] for _, m in recorded] == lrs[2:]
    assert resumed.optimizer.count == straight.optimizer.count == 4
    assert _same(_params(resumed), _params(straight))
    for a, b in zip(resumed.optimizer.mu + resumed.optimizer.nu,
                    straight.optimizer.mu + straight.optimizer.nu):
        assert torch.equal(a, b)


def test_warm_start_loads_weights_and_starts_a_fresh_schedule(tmp_path, recorded, monkeypatch):
    donor = tr.train(_cfg(tmp_path / "donor"), _Loader(), max_steps=2, device="cpu")
    recorded.clear()
    first = {}
    real_make = tr.make_train_step

    def spying_make(model, tcfg, device=None):
        step = real_make(model, tcfg, device=device)

        def wrapped(state, batch):
            first.setdefault("params", _params(state))
            return step(state, batch)

        return wrapped

    monkeypatch.setattr(tr, "make_train_step", spying_make)
    state = tr.train(_cfg(tmp_path / "fine"), _Loader(), max_steps=1, warm_start=str(tmp_path / "donor"),
                     device="cpu")
    assert _same(first["params"], _params(donor))
    assert state.step == 1 and recorded[0][0] == 0
    assert recorded[0][1]["lr"] == pytest.approx(2e-4 / 25)  # the schedule's start


def test_warm_start_refusals(tmp_path):
    os.makedirs(tmp_path / "empty")
    with pytest.raises(ValueError, match="no checkpoint steps"):
        tr.train(_cfg(tmp_path / "ck"), _Loader(), max_steps=1, warm_start=str(tmp_path / "empty"),
                 device="cpu")
    tr.train(_cfg(tmp_path / "ck"), _Loader(), max_steps=1, device="cpu")
    with pytest.raises(ValueError, match="same directory"):
        tr.train(_cfg(tmp_path / "ck"), _Loader(), max_steps=2, warm_start=str(tmp_path / "ck"),
                 device="cpu")


def test_emergency_checkpoint_replays_the_failed_batch(tmp_path, monkeypatch):
    served_a = []
    tr.train(_cfg(tmp_path / "a"), _Loader(served_a), max_steps=3, device="cpu")
    real_make = tr.make_train_step
    calls = {"n": 0}

    def failing_make(model, tcfg, device=None):
        real = real_make(model, tcfg, device=device)

        def step(state, batch):
            calls["n"] += 1
            if calls["n"] == 2:  # the second step (i = 1)
                raise RuntimeError("injected step failure")
            return real(state, batch)

        return step

    monkeypatch.setattr(tr, "make_train_step", failing_make)
    with pytest.raises(RuntimeError, match="injected"):
        tr.train(_cfg(tmp_path / "c"), _Loader(), max_steps=3, device="cpu")
    assert ts.checkpoint_steps(str(tmp_path / "c")) == [1]
    assert glob.glob(str(tmp_path / "c" / "loader_state-1-p0.bin"))
    monkeypatch.setattr(tr, "make_train_step", real_make)
    served = []
    state = tr.train(_cfg(tmp_path / "c"), _Loader(served), max_steps=3, device="cpu")
    assert state.step == 3
    # two fetches before the restore, then batch 1 (the failed step's,
    # replayed), batch 2 and batch 3 (the prefetch)
    assert served[2:] == served_a[1:4] == [1, 2, 3]


def test_divergence_aborts_with_a_finite_checkpoint(tmp_path):
    class Poisoned:
        def __iter__(self):
            yield _batch(0)
            while True:
                yield _batch(1, poison=True)

    with pytest.raises(RuntimeError, match="diverged"):
        tr.train(_cfg(tmp_path / "ck", max_consecutive_nonfinite=3), Poisoned(), device="cpu")
    steps = ts.checkpoint_steps(str(tmp_path / "ck"))
    assert steps == [4]  # one good step and three skipped ones
    ckpt = torch.load(os.path.join(str(tmp_path / "ck"), "4", ts.CHECKPOINT_FILE), weights_only=True)
    assert ckpt["optimizer"]["count"] == 1 and ckpt["optimizer"]["total_notfinite"] == 3
    assert all(bool(torch.isfinite(v).all()) for v in ckpt["model"].values())


def test_exactly_once_data_order_across_resume(tmp_path):
    served_a = []
    tr.train(_cfg(tmp_path / "a"), _Loader(served_a), max_steps=3, device="cpu")
    served_b1, served_b2 = [], []
    tr.train(_cfg(tmp_path / "b"), _Loader(served_b1), max_steps=2, device="cpu")
    assert glob.glob(str(tmp_path / "b" / "loader_state-2-p0.bin"))
    state = tr.train(_cfg(tmp_path / "b"), _Loader(served_b2), max_steps=3, device="cpu")
    assert state.step == 3
    assert served_b1 == served_a[:3]
    assert served_b2[2:] == served_a[2:4]


def test_sigterm_checkpoints_and_stops(tmp_path, monkeypatch):
    real_make = tr.make_train_step

    def signalling_make(model, tcfg, device=None):
        real = real_make(model, tcfg, device=device)

        def step(state, batch):
            out = real(state, batch)
            if state.step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return step

    monkeypatch.setattr(tr, "make_train_step", signalling_make)
    before = signal.getsignal(signal.SIGTERM)
    calls = []
    state = tr.train(_cfg(tmp_path / "ck"), _Loader(), lambda s, i: calls.append(i), max_steps=10,
                     device="cpu")
    assert state.step == 2 and ts.checkpoint_steps(str(tmp_path / "ck")) == [2]
    assert calls == []  # no validation on the way out
    assert signal.getsignal(signal.SIGTERM) is before  # the handler is put back


def test_refusals_without_a_card_or_with_a_mesh(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError):
        tr.train(Config(model=MODEL, mesh=MeshConfig(data=2)), _Loader(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.train(_cfg(tmp_path / "ck"), _Loader(), max_steps=1)


def test_metric_logger_means_and_tensorboard(tmp_path, caplog):
    pytest.importorskip("tensorboard")
    logger = tr.MetricLogger(log_every=2, tb_dir=str(tmp_path / "tb"))
    with caplog.at_level(logging.INFO, logger="anystereo_tpu_torch.train.trainer"):
        logger.push(0, {"loss": torch.tensor(1.0)})
        logger.push(1, {"loss": 3.0})
    logger.close()
    assert "step 1 | loss=2.0000" in caplog.text
    assert glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))


def test_train_from_dataset_files_and_validate_by_name(tmp_path):
    """The tentpole path on the CPU: a SceneFlow tree on disk → multi-scale
    samples → the prefetch loader → `train()` with checkpoints and
    validation by name → `run_validation` of the checkpoint gives the last
    in-training validation's metrics."""
    import make_synthetic_datasets as synth

    root = str(tmp_path / "data")
    rng = np.random.RandomState(0)
    synth.gen_sceneflow(root, rng, n_train=3, n_test=2, h=48, w=96)
    cfg = _cfg(tmp_path / "ck", ckpt_every=2, scale_min=1.0, scale_max=1.4)
    aug = AugmentorConfig(crop_size=cfg.train.inp_size, min_scale=-0.2, max_scale=0.4, yjitter=True)
    ds = fetch_dataset(["sceneflow"], {"sceneflow": root}, aug, multi_scale=True,
                       inp_size=cfg.train.inp_size, scale_min=cfg.train.scale_min,
                       scale_max=cfg.train.scale_max)
    loader = PrefetchLoader(ds, B, num_workers=2, seed=1234)
    inner = make_train_validate_fn(MODEL, "sceneflow", root, valid_iters=1,
                                   max_images=2, device="cpu")
    results = []
    state = tr.train(cfg, loader, lambda s, i: results.append(inner(s, i)) or results[-1],
                     max_steps=2, device="cpu")
    assert state.step == 2 and len(results) == 1
    got = run_validation(MODEL, str(tmp_path / "ck"), "sceneflow", root, valid_iters=1, max_images=2,
                         device="cpu")
    assert got == results[-1]
    assert np.isfinite(got["epe"])
