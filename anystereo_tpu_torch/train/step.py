"""The training and eval steps (twin of `anystereo_tpu/train/step.py`).
Training: train-mode forward → sequence loss (+ optional init-disparity
supervision) → backward → clip → AdamW under the schedule.  Eval: the
disparity at queried coordinates.

The JAX package's `split_opt_step`, mesh arguments and buffer donation are
matters of its compiler and runtime and have no counterpart here.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from anystereo_tpu_torch.config import TrainConfig
from anystereo_tpu_torch.nn.model import AnyStereo
from anystereo_tpu_torch.train.loss import init_disp_loss, sequence_loss_queries
from anystereo_tpu_torch.train.state import TrainState
from anystereo_tpu_torch.utils.device import model_device


def loss_and_metrics(model: AnyStereo, tcfg: TrainConfig, batch: Dict[str, torch.Tensor]):
    """The step's loss (with its autograd graph) and the metrics `epe`,
    `1px`, `3px` of the last iterate."""
    out = model(batch["left"], batch["right"], iters=tcfg.train_iters, coords=batch["coords"],
                scale=batch["scale"], mode="train")
    loss, metrics = sequence_loss_queries(out.disp_preds, batch["gt"], batch["valid"],
                                          max_disp=tcfg.max_disp_loss, gamma=tcfg.loss_gamma)
    if tcfg.supervise_init and out.init_disp is not None:
        loss = loss + init_disp_loss(out.init_disp, batch["gt_low"], tcfg.max_disp_loss)
    return loss, metrics


def make_train_step(
    model: AnyStereo, tcfg: TrainConfig, device=None
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """Returns step(state, batch) -> (state, metrics); the state is updated
    in place.  `model` must lie on `device` (default: the CUDA card; the
    CPU only when asked for by name), and so must the batch.

    batch keys: left/right [B,H,W,3]; coords [B,Q,2]; gt [B,Q] (query-space
    ground-truth disparity); valid [B,Q]; scale [B]; gt_low [B,H/4,W/4]
    (1/4-res ground truth divided by 4*scale, read only with
    `supervise_init`).  metrics: `loss`, `epe`, `1px`, `3px` (0-d tensors),
    `grad_norm` (before clipping), `lr`, and `nonfinite_skips`, the count of
    consecutive skipped steps."""
    model_device(model, device)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.optimizer.zero_grad()
        loss, metrics = loss_and_metrics(model, tcfg, batch)
        loss.backward()
        info = state.optimizer.step()
        state.step += 1
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = info["grad_norm"]
        metrics["lr"] = info["lr"]
        metrics["nonfinite_skips"] = state.optimizer.notfinite_count
        return state, metrics

    return step


def make_eval_step(
    model: AnyStereo, valid_iters: int = 32, device=None
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """Returns step(left, right, coords, scale) -> the disparity at the
    queried coordinates [B, Q], after `valid_iters` iterations in eval mode
    (no autograd graph).  `model` must lie on `device` (default: the CUDA
    card; the CPU only when asked for by name), and so must the inputs."""
    model_device(model, device)

    def step(left, right, coords, scale):
        return model(left, right, iters=valid_iters, coords=coords, scale=scale,
                     mode="eval").disp_final

    return step
