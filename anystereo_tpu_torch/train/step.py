"""The training and eval steps (twin of `anystereo_tpu/train/step.py`).
Training: train-mode forward → sequence loss (+ optional init-disparity
supervision) → backward → clip → AdamW under the schedule.  Eval: the
disparity at queried coordinates.

Data parallel (a process group of more than one rank initialised, one
rank a slice of the batch): the loss is the full batch's, as the JAX package's
GSPMD step computes it.  The counts of valid entries are summed over the
ranks before the forward, each rank's loss and metrics are its share of the
full batch's, and the gradients are summed over the ranks after the
backward, so every rank clips and applies (or skips) the full batch's
gradient and takes the same decision.

Eval over a mesh (`parallel/mesh.make_mesh`): each data group of ranks
takes its slice of the batch, each spatial group tiles the frame's rows
(`parallel/spatial.infer_spatial_sharded`), and every rank returns the
whole batch's result.

The JAX package's `split_opt_step`, the train step's mesh argument and
buffer donation are matters of its compiler and runtime and have no
counterpart here.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from anystereo_tpu_torch.config import TrainConfig
from anystereo_tpu_torch.nn.model import AnyStereo
from anystereo_tpu_torch.parallel.mesh import RankMesh, all_reduce_sum_
from anystereo_tpu_torch.parallel.spatial import gather_batch, infer_spatial_sharded
from anystereo_tpu_torch.train.loss import init_disp_loss, low_mask, query_mask, sequence_loss_queries
from anystereo_tpu_torch.train.state import TrainState
from anystereo_tpu_torch.utils.device import model_device, process_topology
from anystereo_tpu_torch.utils.profiling import span


def loss_and_metrics(model: AnyStereo, tcfg: TrainConfig, batch: Dict[str, torch.Tensor],
                     counts: Optional[torch.Tensor] = None):
    """The step's loss (with its autograd graph) and the metrics `epe`,
    `1px`, `3px` of the last iterate.  `counts`: the valid queries and
    valid 1/4-res ground-truth entries to divide by ([2]; default: this
    batch's)."""
    q_count, low_count = (None, None) if counts is None else counts
    with span("forward"):
        out = model(batch["left"], batch["right"], iters=tcfg.train_iters, coords=batch["coords"],
                    scale=batch["scale"], mode="train")
    with span("loss"):
        loss, metrics = sequence_loss_queries(out.disp_preds, batch["gt"], batch["valid"],
                                              max_disp=tcfg.max_disp_loss, gamma=tcfg.loss_gamma,
                                              count=q_count)
        if tcfg.supervise_init and out.init_disp is not None:
            loss = loss + init_disp_loss(out.init_disp, batch["gt_low"], tcfg.max_disp_loss, low_count)
    return loss, metrics


def _global_counts(tcfg: TrainConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[valid queries, valid 1/4-res entries] summed over the ranks."""
    counts = torch.stack([query_mask(batch["gt"], batch["valid"], tcfg.max_disp_loss).sum(),
                          low_mask(batch["gt_low"], tcfg.max_disp_loss).sum()])
    all_reduce_sum_([counts])
    return counts


def make_train_step(
    model: AnyStereo, tcfg: TrainConfig, device=None
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """Returns step(state, batch) -> (state, metrics); the state is updated
    in place.  `model` must lie on `device` (default: the CUDA card; the
    CPU only when asked for by name), and so must the batch.  Under a
    process group of more than one rank the batch is this rank's slice and
    the step and its metrics are the full batch's (module docstring).

    batch keys: left/right [B,H,W,3]; coords [B,Q,2]; gt [B,Q] (query-space
    ground-truth disparity); valid [B,Q]; scale [B]; gt_low [B,H/4,W/4]
    (1/4-res ground truth divided by 4*scale, read only with
    `supervise_init`).  metrics: `loss`, `epe`, `1px`, `3px` (0-d tensors),
    `grad_norm` (before clipping), `lr`, and `nonfinite_skips`, the count of
    consecutive skipped steps."""
    model_device(model, device)
    distributed = process_topology()[1] > 1

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with span("train_step"):
            state.optimizer.zero_grad()
            counts = _global_counts(tcfg, batch) if distributed else None
            loss, metrics = loss_and_metrics(model, tcfg, batch, counts)
            with span("backward"):
                loss.backward()
            metrics = dict(metrics, loss=loss.detach())
            if distributed:
                with span("grad_sum"):
                    for p in state.optimizer.params:
                        if p.grad is None:
                            p.grad = torch.zeros_like(p)
                    all_reduce_sum_([p.grad for p in state.optimizer.params])
                    names = sorted(metrics)
                    shares = torch.stack([metrics[k] for k in names])
                    all_reduce_sum_([shares])
                    metrics = dict(zip(names, shares.unbind()))
            with span("optimizer"):
                info = state.optimizer.step()
            state.step += 1
            metrics["grad_norm"] = info["grad_norm"]
            metrics["lr"] = info["lr"]
            metrics["nonfinite_skips"] = state.optimizer.notfinite_count
            return state, metrics

    return step


def make_eval_step(
    model: AnyStereo, valid_iters: int = 32, device=None, mesh: Optional[RankMesh] = None
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """Returns step(left, right, coords, scale) -> the disparity at the
    queried coordinates [B, Q], after `valid_iters` iterations in eval mode
    (no autograd graph).  `model` must lie on `device` (default: the CUDA
    card; the CPU only when asked for by name), and so must the inputs.

    `mesh` (every rank calls the step with the whole batch): with data > 1
    the rank computes its data index's slice of the batch (B a multiple of
    data) and the slices are gathered over its data group; with spatial > 1
    its spatial group tiles the rows.  Every rank returns the whole [B, Q]."""
    model_device(model, device)

    def forward(left, right, coords, scale):
        if mesh is not None and mesh.spatial > 1:
            return infer_spatial_sharded(model, None, left, right, coords, scale, mesh.spatial_group,
                                         iters=valid_iters)
        return model(left, right, iters=valid_iters, coords=coords, scale=scale,
                     mode="eval").disp_final

    def gathered(left, right, coords, scale):
        b = left.shape[0]
        if b % mesh.data:
            raise ValueError(f"batch {b} does not split over the mesh's data axis of {mesh.data}")
        rows = slice(mesh.data_index * b // mesh.data, (mesh.data_index + 1) * b // mesh.data)

        def mine(t):
            return t[rows] if torch.is_tensor(t) and t.dim() and t.shape[0] == b else t

        out = forward(mine(left), mine(right), mine(coords), mine(scale))
        return gather_batch(out, mesh.data_group)

    run = forward if mesh is None or mesh.data == 1 else gathered

    def step(left, right, coords, scale):
        with span("eval_step"):
            return run(left, right, coords, scale)

    return step
