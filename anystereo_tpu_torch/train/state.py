"""Train state and checkpoints (twin of `anystereo_tpu/train/state.py`).

A checkpoint is the full state, saved with `torch.save`: the model's
`state_dict` (parameters and buffers, so frozen-BatchNorm statistics go with
it), the optimizer's moments and counters, `step` and the skip counters.
Each lies in its own numbered step directory of the checkpoint directory,
`<ckpt_dir>/<step>/checkpoint.pt`, written under a temporary name and
renamed into place; the newest `keep` (5) are kept, as the JAX package's
Orbax manager keeps them, so a directory "has steps" in both packages alike.
Restoring maps every tensor onto the device of the state it is restored
into, so a checkpoint saved on the CPU restores onto the card and the
reverse.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
from typing import Dict, Mapping, Optional

import torch

from anystereo_tpu_torch.config import TrainConfig
from anystereo_tpu_torch.nn.model import AnyStereo
from anystereo_tpu_torch.train.optimizer import Optimizer, make_optimizer
from anystereo_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

CHECKPOINT_FILE = "checkpoint.pt"


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the state's), the optimizer (moments,
    the count of applied updates and the skip counters) and `step`, the
    number of training steps taken, skipped ones included.  A training step
    updates the state in place."""

    model: AnyStereo
    optimizer: Optimizer
    step: int = 0

    @property
    def notfinite_count(self) -> int:
        """Consecutive steps skipped for non-finite gradients."""
        return self.optimizer.notfinite_count

    @property
    def total_notfinite(self) -> int:
        """Steps skipped for non-finite gradients so far."""
        return self.optimizer.total_notfinite


def create_train_state(model: AnyStereo, tcfg: TrainConfig, device=None) -> TrainState:
    """Move `model` to `device` (default: the CUDA card; the CPU only when
    asked for by name) and give it the optimizer of `tcfg`."""
    model = model.to(resolve_device(device))
    opt = make_optimizer(model.parameters(), lr=tcfg.lr, weight_decay=tcfg.weight_decay,
                         num_steps=tcfg.num_steps, grad_clip=tcfg.grad_clip,
                         pct_start=tcfg.warmup_frac, skip_nonfinite=tcfg.skip_nonfinite)
    return TrainState(model=model, optimizer=opt)


# --------------------------------------------------------------------- #
# checkpoint files
# --------------------------------------------------------------------- #


def checkpoint_steps(ckpt_dir: str):
    """The steps saved in `ckpt_dir`, ascending ([] when it does not exist)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(e.name) for e in os.scandir(ckpt_dir)
                  if e.name.isdigit() and os.path.isfile(os.path.join(e.path, CHECKPOINT_FILE)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = checkpoint_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load(ckpt_dir: str, step: Optional[int]):
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"{ckpt_dir}: no checkpoint steps")
    path = os.path.join(ckpt_dir, str(step), CHECKPOINT_FILE)
    return step, torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(ckpt_dir: str, state: TrainState, keep: int = 5) -> str:
    """Save the full state as step `state.step`; raises `FileExistsError`
    when that step is already saved.  Returns the checkpoint's path."""
    final = os.path.join(ckpt_dir, str(state.step))
    if os.path.exists(final):
        raise FileExistsError(f"{final}: step {state.step} is already saved")
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    names = [n for n, _ in state.model.named_parameters()]
    opt = state.optimizer
    torch.save({
        "step": state.step,
        "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "optimizer": {
            "mu": {n: m.cpu() for n, m in zip(names, opt.mu)},
            "nu": {n: m.cpu() for n, m in zip(names, opt.nu)},
            "count": opt.count,
            "notfinite_count": opt.notfinite_count,
            "total_notfinite": opt.total_notfinite,
        },
    }, os.path.join(tmp, CHECKPOINT_FILE))
    os.replace(tmp, final)
    for old in checkpoint_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)), ignore_errors=True)
    return os.path.join(final, CHECKPOINT_FILE)


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, state: TrainState, step: Optional[int] = None) -> TrainState:
    """Restore the full state saved at `step` (default: the latest) into
    `state`, in place, on its device; returns it."""
    step, ckpt = _load(ckpt_dir, step)
    state.model.load_state_dict(ckpt["model"], strict=True)
    names = [n for n, _ in state.model.named_parameters()]
    opt, saved = state.optimizer, ckpt["optimizer"]
    for n, mu, nu in zip(names, opt.mu, opt.nu):
        mu.copy_(saved["mu"][n])
        nu.copy_(saved["nu"][n])
    opt.count = saved["count"]
    opt.notfinite_count = saved["notfinite_count"]
    opt.total_notfinite = saved["total_notfinite"]
    state.step = int(ckpt["step"])
    return state


def _merge(donor: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor]):
    out = {}
    for name, value in params.items():
        new = donor.get(name)
        if new is not None and tuple(new.shape) == tuple(value.shape):
            out[name] = new.to(dtype=value.dtype, device=value.device)
        else:
            out[name] = value
    return out


def restore_params_only(ckpt_dir: str, params: Mapping[str, torch.Tensor],
                        step: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Weight-only restore for warm-starting from a differently configured
    run: for each entry of `params` (name -> tensor, e.g. a model's
    `named_parameters()`), the checkpoint's tensor of the same name and shape
    (in the entry's dtype, on its device), else the entry itself."""
    return _merge(_load(ckpt_dir, step)[1]["model"], params)


@torch.no_grad()
def restore_eval_variables(ckpt_dir: str, model: torch.nn.Module,
                           step: Optional[int] = None) -> torch.nn.Module:
    """Load a checkpoint's weights into `model`, in place: the parameters
    as `restore_params_only` merges them, and the buffers (frozen-BatchNorm
    statistics) of the same name and shape.  A buffer the checkpoint lacks
    keeps its value, with a warning: frozen-BatchNorm metrics are
    meaningless without the trained statistics.  Returns the model."""
    donor = _load(ckpt_dir, step)[1]["model"]
    params = dict(model.named_parameters())
    for name, value in _merge(donor, params).items():
        if value is not params[name]:
            params[name].copy_(value)
    buffers = dict(model.named_buffers())
    merged = _merge(donor, buffers)
    for name, value in merged.items():
        if value is not buffers[name]:
            buffers[name].copy_(value)
    missing = [n for n in buffers if merged[n] is buffers[n]]
    if missing:
        log.warning("checkpoint %s has no %s; using the model's own values — frozen-BatchNorm "
                    "eval metrics are meaningless without the trained statistics", ckpt_dir, missing)
    return model
