"""Optimizer and learning-rate schedule (twin of
`anystereo_tpu/train/optimizer.py`): clip by global norm, then AdamW under
the linear OneCycle schedule, with a skip of non-finite updates.

The schedules are plain functions of the count of applied updates.
`torch.optim.lr_scheduler.OneCycleLR` is not used: its default anneal is a
cosine, it cycles momentum and its end points differ.  The clip follows the
JAX package's rule exactly (`g` unchanged while the norm is below the
bound, else `g / norm * bound`); `torch.nn.utils.clip_grad_norm_` divides
by `norm + 1e-6` instead.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence

import torch

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int, count: int) -> float:
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def one_cycle_schedule(max_lr: float, total_steps: int, pct_start: float = 0.01) -> Schedule:
    """Linear OneCycle over a cycle of `total_steps + 100`: warm up from
    max_lr/25 to max_lr over `max(int(cycle * pct_start), 1)` updates, then
    anneal linearly to max_lr/1e4."""
    total = total_steps + 100
    warm = max(int(total * pct_start), 1)

    def schedule(count: int) -> float:
        if count < warm:
            return _linear(max_lr / 25.0, max_lr, warm, count)
        return _linear(max_lr, max_lr / 1e4, total - warm, count - warm)

    return schedule


def step_decay_schedule(base_lr: float, milestones: Sequence[int], gamma: float = 0.5) -> Schedule:
    """Piecewise step decay: lr = base * gamma^(number of milestones
    reached); `milestones` in updates."""
    marks = sorted(int(m) for m in milestones)
    return lambda count: base_lr * gamma ** sum(count >= m for m in marks)


class Optimizer:
    """Clip by global norm → AdamW (decoupled weight decay), the update
    skipped when a gradient is not finite.

    The gradients are read from the parameters' `.grad` (a parameter
    without one counts as zero, as in a JAX gradient tree) and clipped in
    place.  State: `mu`, `nu` (Adam's moments, one per parameter), `count`
    (updates applied, which is also the schedule's argument),
    `notfinite_count` (consecutive skipped steps, back to 0 at the first
    finite one) and `total_notfinite`.  A skipped step leaves parameters,
    moments and `count` untouched.  There is no give-up threshold: the
    caller aborts after too many consecutive skips."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Schedule,
                 weight_decay: float = 1e-5, grad_clip: float = 1.0,
                 skip_nonfinite: bool = True, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params: List[torch.nn.Parameter] = list(params)
        self.schedule = schedule
        self.weight_decay, self.grad_clip, self.skip_nonfinite = weight_decay, grad_clip, skip_nonfinite
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.notfinite_count = 0
        self.total_notfinite = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> Dict[str, float]:
        """One update from the parameters' `.grad`.  Returns `grad_norm`
        (before clipping), `lr` and whether the update was `applied`.  Reads
        the norm back to the host: one synchronisation per step."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        # sqrt of the sum of squares over all leaves; a leaf's norm is finite
        # iff its entries are (a leaf whose squares overflow fp32 counts as
        # non-finite too)
        norm = float(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))))
        finite = norm == norm and norm != float("inf")
        lr = self.schedule(self.count)
        if self.skip_nonfinite and not finite:
            self.notfinite_count += 1
            self.total_notfinite += 1
            return {"grad_norm": norm, "lr": lr, "applied": False}
        self.notfinite_count = 0
        if not norm < self.grad_clip:
            torch._foreach_div_(grads, norm)
            torch._foreach_mul_(grads, self.grad_clip)
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        denom = torch._foreach_sqrt(self.nu)
        torch._foreach_div_(denom, bc2 ** 0.5)
        torch._foreach_add_(denom, self.eps)
        # p - lr * (mu_hat / denom + wd * p)
        torch._foreach_mul_(self.params, 1.0 - lr * self.weight_decay)
        torch._foreach_addcdiv_(self.params, self.mu, denom, value=-lr / bc1)
        return {"grad_norm": norm, "lr": lr, "applied": True}


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    lr: float = 2e-4,
    weight_decay: float = 1e-5,
    num_steps: int = 100_000,
    grad_clip: float = 1.0,
    pct_start: float = 0.01,
    skip_nonfinite: bool = True,
) -> Optimizer:
    """Clip at `grad_clip` → AdamW(b1 0.9, b2 0.999, eps 1e-8) under
    `one_cycle_schedule(lr, num_steps, pct_start)`."""
    return Optimizer(params, one_cycle_schedule(lr, num_steps, pct_start), weight_decay,
                     grad_clip, skip_nonfinite)
