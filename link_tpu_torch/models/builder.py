"""Name-dispatched factories for the seg stack: model, optimizer and lr
schedule from a config (counterpart of `link_tpu/models/builder.py:46-109,
156-167`; reference: segmentation/core/builder.py:16-124)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..train import schedules
from ..train.trainer import make_sgd
from .linkunet import DEFAULT_CAPACITIES, ELKUNet


def make_model(cfg, capacities: Optional[Tuple[int, ...]] = None,
               dtype: str = "float32", device="cuda",
               generator: Optional[torch.Generator] = None,
               grid_extent=None) -> torch.nn.Module:
    m = cfg.model
    caps = tuple(capacities or m.get("capacities", DEFAULT_CAPACITIES))
    name = m.name
    if name == "linkunet":
        return ELKUNet(num_classes=cfg.data.num_classes, cr=m.get("cr", 1.0),
                       r=m.r, s=m.s, groups=m.groups, baseop=m.base_op,
                       capacities=caps, dtype=dtype, grid_extent=grid_extent,
                       device=device, generator=generator)
    if name in ("linkencoder", "minkunet", "spvcnn"):
        raise NotImplementedError(
            f"model {name!r} is not ported yet: it comes with the slice of "
            "the other seg families (ELKEncoder, MinkUNet, SPVCNN)")
    raise NotImplementedError(name)


def make_lr_schedule(cfg, world_size: int = 1):
    """step -> lr, a plain function."""
    s = cfg.scheduler.name
    base_lr = cfg.optimizer.lr
    if s == "none":
        return lambda step: base_lr
    if s == "cosine_warmup":
        return schedules.cosine_warmup(
            base_lr, cfg.num_epochs, cfg.batch_size * world_size,
            cfg.data.training_size, world_size)
    raise NotImplementedError(
        f"scheduler {s!r} is not ported yet (cosine_warmup and none are)")


def make_optimizer(cfg, params, lr: float) -> torch.optim.Optimizer:
    """The config's optimizer over `params`, starting at `lr` (the training
    loop sets each step's lr from the schedule)."""
    o = cfg.optimizer
    if o.name == "sgd":
        return make_sgd(params, lr, momentum=o.momentum,
                        weight_decay=o.weight_decay, nesterov=o.nesterov)
    raise NotImplementedError(
        f"optimizer {o.name!r} is not ported yet (sgd is; adam and adamw "
        "come with det training)")
