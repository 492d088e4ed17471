"""The training loop (twin of `anystereo_tpu/train/trainer.py`): data →
train step → logging → checkpoints → periodic validation.

AdamW under OneCycle, clip 1.0, bf16; a checkpoint every `ckpt_every` steps
and at the end; running means of the metrics every `log_every` steps to the
console and, where `torch.utils.tensorboard` imports, to TensorBoard.
Full-state checkpoints, so a resume continues the schedule; one batch is
copied to the card ahead of the step.  Preemption and failures: SIGTERM and
SIGINT checkpoint and stop; a failing step saves an emergency checkpoint
(with a loader sidecar that replays the failed batch) before re-raising;
`max_consecutive_nonfinite` skipped steps in a row abort with the last finite
state saved.

Data parallel (`cfg.mesh.data` > 1, or 0 under an initialised process group
of more than one rank; `parallel/mesh.py`): each rank trains on
`cuda:LOCAL_RANK` (or the CPU when asked for by name), loads its own slice
of every batch, starts from rank 0's weights and steps on the full batch's
gradient (`train/step.py`).  Only rank 0 writes checkpoints and logs
metrics and validation results; each rank writes its loader's sidecar.
Every rank calls `validate_fn` (`make_train_validate_fn`'s splits the frames
over the ranks, so no rank waits on another's whole validation).  A stop on
a signal is taken by every rank at the same step.
"""

from __future__ import annotations

import glob
import logging
import os
import signal
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from anystereo_tpu_torch.config import Config
from anystereo_tpu_torch.data.loader import CheckpointablePrefetch, device_prefetch, to_device
from anystereo_tpu_torch.nn.model import build_model
from anystereo_tpu_torch.parallel.mesh import (
    all_reduce_sum_,
    broadcast_from_rank0_,
    check_mesh,
    rank_device,
)
from anystereo_tpu_torch.train.state import (
    TrainState,
    checkpoint_steps,
    create_train_state,
    restore_checkpoint,
    restore_eval_variables,
    save_checkpoint,
)
from anystereo_tpu_torch.train.step import make_train_step
from anystereo_tpu_torch.utils.device import process_topology, resolve_device
from anystereo_tpu_torch.utils.profiling import span

log = logging.getLogger(__name__)


class MetricLogger:
    """Running-mean console / TensorBoard logger."""

    def __init__(self, log_every: int = 100, tb_dir: Optional[str] = None):
        self.log_every = log_every
        self.running: Dict[str, float] = {}
        self.count = 0
        self.writer = None
        if tb_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                log.warning("tensorboard unavailable; console logging only")
            else:
                self.writer = SummaryWriter(tb_dir)

    def push(self, step: int, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
        self.count += 1
        if self.writer is not None:
            for k, v in metrics.items():
                self.writer.add_scalar(f"train/{k}", float(v), step)
        if self.count == self.log_every:
            means = {k: v / self.count for k, v in self.running.items()}
            log.info("step %d | %s", step, " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items())))
            self.running, self.count = {}, 0

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


def _loader_state_path(ckpt_dir: str, step: int) -> str:
    """Sidecar file with the checkpointable iterator's state for `step`
    (one per process: each owns its shard's order)."""
    return os.path.join(ckpt_dir, f"loader_state-{step}-p{process_topology()[0]}.bin")


def _save_loader_state(ckpt_dir: str, step: int, state_bytes) -> None:
    """Write the iterator state (as `CheckpointablePrefetch` captured it: its
    next fetch is the batch for `step`) beside the checkpoint, and delete
    this process's sidecars whose checkpoint step was pruned."""
    if isinstance(state_bytes, str):
        state_bytes = state_bytes.encode()
    with open(_loader_state_path(ckpt_dir, step), "wb") as f:
        f.write(state_bytes)
    kept = {str(s) for s in checkpoint_steps(ckpt_dir)}
    for p in glob.glob(os.path.join(ckpt_dir, f"loader_state-*-p{process_topology()[0]}.bin")):
        s = os.path.basename(p).split("-")[1]
        if s not in kept and s != str(step):
            try:
                os.remove(p)
            except FileNotFoundError:
                pass


def _wait(it):
    """The loader's next batch, in a `loader_wait` span."""
    with span("loader_wait"):
        return next(it)


def train(
    cfg: Config,
    loader,
    validate_fn: Optional[Callable[[TrainState, int], Dict[str, float]]] = None,
    state: Optional[TrainState] = None,
    max_steps: Optional[int] = None,
    warm_start: Optional[str] = None,
    device=None,
) -> TrainState:
    """Run the training loop.  `loader` yields numpy batches with the
    `make_train_step` contract; `validate_fn(state, step)` runs held-out
    validation after each checkpoint, on every rank.  Without `state` the
    model is built from `cfg.model` with weights seeded by `cfg.train.seed`,
    on `device` (default: the CUDA card; the CPU only when asked for by
    name); a given `state` carries its own model and device.

    `warm_start`: a checkpoint directory whose weights are loaded before
    training starts (merged by name and shape; the schedule starts at step
    0).  Auto-resume of the full state from `cfg.train.ckpt_dir` takes
    precedence when that directory already holds steps."""
    rank, world = process_topology()
    data, spatial = check_mesh(cfg.mesh, world)
    if spatial > 1:
        raise NotImplementedError(
            f"train() with mesh spatial={spatial}: the port tiles rows for inference only "
            "(parallel/spatial.py); the JAX package's train() only replicates the step over that axis "
            "(its batch is sharded on `data` alone), so train with MeshConfig(spatial=1)")
    distributed = data > 1
    tcfg = cfg.train
    if state is not None:
        dev = next(state.model.parameters()).device
    elif distributed:
        dev = rank_device(device)
    else:
        dev = resolve_device(device)
    if distributed and dev.type == "cuda":
        torch.cuda.set_device(dev)

    raw_it = iter(loader)
    # A checkpointable iterator (get_state/set_state) goes through
    # CheckpointablePrefetch, which snapshots the iterator state around
    # every fetch, so a checkpoint saves the state paired with the batch
    # actually consumed (a plain prefetch would run ahead of it).
    ckptable_loader = hasattr(raw_it, "get_state") and hasattr(raw_it, "set_state")

    def prefetch(it):
        if ckptable_loader:
            return CheckpointablePrefetch(it, place=lambda b: to_device(b, dev))
        return device_prefetch(it, device=dev)

    it = prefetch(raw_it)
    first = _wait(it)

    if state is None:
        model = build_model(cfg.model, dev, seed=tcfg.seed)
        log.info("parameter count: %.2fM", sum(p.numel() for p in model.parameters()) / 1e6)
        resume_available = bool(checkpoint_steps(tcfg.ckpt_dir))
        if warm_start is not None:
            # fail clearly on a typo'd or empty directory, and refuse the
            # silent no-op where auto-resume from the same directory would
            # override the warm start at once
            if not checkpoint_steps(warm_start):
                raise ValueError(
                    f"--restore directory {warm_start!r} has no checkpoint steps "
                    "(expected numbered step subdirectories)")
            if os.path.abspath(warm_start) == os.path.abspath(tcfg.ckpt_dir):
                raise ValueError(
                    f"--restore and ckpt_dir are the same directory ({warm_start!r}): "
                    "auto-resume would restore the full donor state over the warm start "
                    "and run the schedule from the donor's step — pass a fresh --ckpt-dir "
                    "for fine-tunes")
            if resume_available:
                log.warning(
                    "ckpt_dir %s already holds checkpoint steps — auto-resume takes "
                    "precedence and the warm start from %s is DISCARDED (expected when "
                    "resuming a preempted fine-tune; otherwise pass a fresh --ckpt-dir)",
                    tcfg.ckpt_dir, warm_start)
            else:
                restore_eval_variables(warm_start, model)
                log.info("warm-started weights from %s", warm_start)
        if distributed:
            broadcast_from_rank0_(model)
        state = create_train_state(model, tcfg, dev)
        if resume_available:
            state = restore_checkpoint(tcfg.ckpt_dir, state)
            log.info("resumed from step %d", state.step)
            if ckptable_loader:
                lp = _loader_state_path(tcfg.ckpt_dir, state.step)
                if os.path.exists(lp):
                    with open(lp, "rb") as f:
                        raw_it.set_state(f.read())
                    # rebuild the prefetch over the restored order (its
                    # buffered batch predates the set_state)
                    it = prefetch(raw_it)
                    first = _wait(it)
                    log.info("restored loader state from %s", lp)
                else:
                    log.warning("no loader state saved for step %d — the data order "
                                "restarts from epoch 0 on this resume", state.step)

    step_fn = make_train_step(state.model, tcfg, device=dev)
    logger = MetricLogger(log_every=100)

    def checkpoint(loader_state) -> None:
        if rank == 0:
            save_checkpoint(tcfg.ckpt_dir, state)
        if ckptable_loader:
            _save_loader_state(tcfg.ckpt_dir, state.step, loader_state)

    def stop_now() -> bool:
        """Whether any rank was asked to stop (every rank must agree)."""
        if not distributed:
            return stop_requested["flag"]
        flag = torch.tensor([float(stop_requested["flag"])], device=dev)
        all_reduce_sum_([flag])
        return bool(flag.item() > 0)

    total = max_steps or tcfg.num_steps
    start = state.step
    t0 = time.time()
    batch = first

    stop_requested = {"flag": False}

    def _request_stop(signum, frame):
        log.warning("signal %s received — will checkpoint and stop", signum)
        stop_requested["flag"] = True

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _request_stop)
        except ValueError:  # not the main thread
            pass

    try:
        for i in range(start, total):
            try:
                state, metrics = step_fn(state, batch)
            except Exception:
                log.exception("step %d failed — saving emergency checkpoint", i)
                # the emergency save must never mask the real failure: this
                # step may already be saved (a failure right after a resume)
                try:
                    # state.step == i and the failed batch was i's: the
                    # sidecar points at batch i, so a resume replays it
                    checkpoint(it.state_of_current if ckptable_loader else None)
                except Exception:
                    log.exception("emergency checkpoint failed")
                raise
            if rank == 0:
                logger.push(i, metrics)
            skips = int(metrics["nonfinite_skips"])
            if skips == 1:
                log.warning("step %d: nonfinite gradients — update skipped (loss=%s grad_norm=%s)",
                            i, float(metrics["loss"]), float(metrics["grad_norm"]))
            if skips >= tcfg.max_consecutive_nonfinite:
                # skipped updates keep the parameters finite; persistent
                # non-finite gradients are divergence: stop with the last
                # finite state saved
                log.error("training diverged: %d consecutive nonfinite steps — saving "
                          "emergency checkpoint and aborting", skips)
                try:
                    checkpoint(it.state_after_current if ckptable_loader else None)
                except Exception:
                    log.exception("divergence checkpoint failed")
                raise RuntimeError(
                    f"training diverged at step {i}: {skips} consecutive nonfinite gradient "
                    f"steps (params remain finite; checkpoint saved to {tcfg.ckpt_dir})")
            stop = stop_now()
            if (i + 1) % tcfg.ckpt_every == 0 or i + 1 == total or stop:
                checkpoint(it.state_after_current if ckptable_loader else None)
                if validate_fn is not None and not stop:
                    results = validate_fn(state, i + 1)
                    if rank == 0:
                        log.info("validation @%d: %s", i + 1, results)
                if distributed:
                    dist.barrier()
            if stop:
                log.info("stopping at step %d on request", i + 1)
                break
            if i + 1 < total:
                batch = _wait(it)
    finally:
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
        logger.close()
        close = getattr(raw_it, "close", None)
        if close is not None:  # the loader's worker processes or threads
            close()
    dt = time.time() - t0
    steps_done = max(total - start, 0)
    log.info("trained %d steps in %.1fs (%.2f steps/s)", steps_done, dt, steps_done / max(dt, 1e-9))
    return state
