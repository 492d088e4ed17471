"""Train state (twin of the `TrainState` of `anystereo_tpu/train/state.py`;
checkpoint files are not ported yet)."""

from __future__ import annotations

import dataclasses

from anystereo_tpu_torch.config import TrainConfig
from anystereo_tpu_torch.nn.model import AnyStereo
from anystereo_tpu_torch.train.optimizer import Optimizer, make_optimizer
from anystereo_tpu_torch.utils.device import resolve_device


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
