"""LR schedules as plain functions of the step.

Counterpart of `link_tpu/train/schedules.py:cosine_warmup` (reference:
segmentation/core/schedulers.py:7-20, cosine with warmup, stepped per
iteration). The training loop sets the optimizer's lr from it before each
step (`trainer.seg_train_step(lr=...)`).
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
