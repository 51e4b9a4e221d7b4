"""LR schedules as plain functions of the step.

Counterpart of `link_tpu/train/schedules.py`: `cosine_warmup` (reference:
segmentation/core/schedulers.py:7-20, cosine with warmup, stepped per
iteration), `one_cycle` (detection/det3d/solver/
learning_schedules_fastai.py:77-97, lr and momentum) and the `lr_updater`
family of torchie's hooks. The training loops read the schedule's value
before each step (`trainer.seg_train_step(lr=...)`, `det_trainer.
OneCycleAdam`).
"""

from __future__ import annotations

import math


def cosine_warmup(base_lr: float, num_epochs: int, global_batch_size: int,
                  dataset_size: int, world_size: int = 1):
    """Per-iteration schedule: warmup_iters = 0 on a single replica, else
    1000 // world_size linear warmup steps; then a cosine over num_epochs *
    iters_per_epoch."""
    warmup_iters = 0 if world_size == 1 else 1000 // world_size
    iter_per_epoch = (dataset_size + global_batch_size - 1) // global_batch_size
    total = num_epochs * iter_per_epoch

    def schedule(step: int) -> float:
        if step < warmup_iters:
            return base_lr * (step + 1) / max(warmup_iters, 1)
        ratio = (step - warmup_iters) / total
        return base_lr * 0.5 * (1 + math.cos(math.pi * ratio))

    return schedule


def _annealing_cos(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)


def one_cycle(lr_max: float, total_steps: int, moms=(0.95, 0.85),
              div_factor: float = 10.0, pct_start: float = 0.4):
    """fastai OneCycle (learning_schedules_fastai.py:77-97): phase 1 ramps
    the lr lr_max / div -> lr_max while the momentum anneals high -> low;
    phase 2 anneals the lr lr_max -> (lr_max / div) / 1e4 and the momentum
    back up. The phase-2 floor is low / 1e4 (:88), not lr_max / 1e4; the
    phase boundary is int(pct_start * total_steps). Returns (lr_fn,
    mom_fn), plain functions of the step."""
    low = lr_max / div_factor
    split = int(pct_start * total_steps)

    def _phases(step):
        p1 = min(max(step / max(split, 1), 0.0), 1.0)
        p2 = min(max((step - split) / max(total_steps - split, 1), 0.0), 1.0)
        return step < split, p1, p2

    def lr_fn(step: int) -> float:
        first, p1, p2 = _phases(step)
        return (_annealing_cos(low, lr_max, p1) if first
                else _annealing_cos(lr_max, low / 1e4, p2))

    def mom_fn(step: int) -> float:
        first, p1, p2 = _phases(step)
        return (_annealing_cos(moms[0], moms[1], p1) if first
                else _annealing_cos(moms[1], moms[0], p2))

    return lr_fn, mom_fn


def lr_updater(policy: str, base_lr: float, *, by_epoch: bool = True,
               steps_per_epoch: int = 1, max_steps: int = 1,
               max_epochs: int = 1, warmup: str = None,
               warmup_iters: int = 0, warmup_ratio: float = 0.1, **kw):
    """The torchie LrUpdaterHook family as a step -> lr function
    (detection/det3d/torchie/trainer/hooks/lr_updater.py:10-175).

    policy: fixed | step (kw: step = int or a list of milestones, gamma
    0.1) | exp (kw: gamma) | poly (kw: power 1.0, min_lr 0.0) | inv (kw:
    gamma, power 1.0) | cosine (kw: target_lr 0.0).

    by_epoch=True evaluates the policy at progress = step // steps_per_epoch
    against max_epochs, by_epoch=False at progress = step against
    max_steps. warmup (constant, linear or exp) rescales the policy's lr in
    the first warmup_iters iterations in both modes."""
    gamma = kw.get("gamma", 0.1)

    def regular(progress: int, max_progress: int) -> float:
        if policy == "fixed":
            return base_lr
        if policy == "step":
            s = kw["step"]
            exp = (progress // s if isinstance(s, int)
                   else sum(progress >= m for m in s))
            return base_lr * gamma ** exp
        if policy == "exp":
            return base_lr * gamma ** progress
        if policy == "poly":
            coeff = (1 - progress / max_progress) ** kw.get("power", 1.0)
            min_lr = kw.get("min_lr", 0.0)
            return (base_lr - min_lr) * coeff + min_lr
        if policy == "inv":
            return base_lr * (1 + gamma * progress) ** (-kw.get("power", 1.0))
        if policy == "cosine":
            target = kw.get("target_lr", 0.0)
            return target + 0.5 * (base_lr - target) * (
                1 + math.cos(math.pi * progress / max_progress))
        raise ValueError(f"unknown lr policy {policy!r}")

    def lr_fn(step: int) -> float:
        step = int(step)
        reg = (regular(step // steps_per_epoch, max_epochs) if by_epoch
               else regular(step, max_steps))
        if warmup is None or step >= warmup_iters:
            return reg
        if warmup == "constant":
            return reg * warmup_ratio
        if warmup == "linear":
            return reg * (1 - (1 - step / warmup_iters) * (1 - warmup_ratio))
        if warmup == "exp":
            return reg * warmup_ratio ** (1 - step / warmup_iters)
        raise ValueError(f"unknown warmup {warmup!r}")

    return lr_fn
