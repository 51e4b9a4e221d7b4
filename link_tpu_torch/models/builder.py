"""Name-dispatched factories for the seg stack: model, optimizer and lr
schedule from a config (counterpart of `link_tpu/models/builder.py:46-109,
156-167`; reference: segmentation/core/builder.py:16-124)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..train import schedules
from ..train.trainer import make_sgd
from .linkencoder import ELKEncoder
from .linkunet import DEFAULT_CAPACITIES, ELKUNet
from .minkunet import MinkUNet
from .spvcnn import SPVCNN


def make_model(cfg, capacities: Optional[Tuple[int, ...]] = None,
               dtype: str = "float32", device="cuda",
               generator: Optional[torch.Generator] = None,
               grid_extent=None) -> torch.nn.Module:
    """The config's seg model. `grid_extent` reaches the models with ELK
    blocks (their dense aux path); SPVCNN runs float32 only, as the JAX
    model, and its dropout is seeded from `generator`'s seed."""
    m = cfg.model
    caps = tuple(capacities or m.get("capacities", DEFAULT_CAPACITIES))
    num_classes = cfg.data.num_classes
    cr = m.get("cr", 1.0)
    kw = dict(capacities=caps, device=device, generator=generator)
    name = m.name
    if name == "linkunet":
        return ELKUNet(num_classes=num_classes, cr=cr, r=m.r, s=m.s,
                       groups=m.groups, baseop=m.base_op, dtype=dtype,
                       grid_extent=grid_extent, **kw)
    if name == "linkencoder":
        return ELKEncoder(num_classes=num_classes, cr=cr, r=m.r, s=m.s,
                          groups=m.groups, baseop=m.base_op, dtype=dtype,
                          grid_extent=grid_extent, **kw)
    if name == "minkunet":
        # the default (64,) * 9 is the reference's actual plan
        # (minkunet.py:98); model.channels selects another, e.g. the stock
        # SPVNAS [32, 32, 64, 128, ...]
        if "channels" in m:
            kw["channels"] = tuple(int(c) for c in m.channels)
        return MinkUNet(num_classes=num_classes, cr=cr, dtype=dtype, **kw)
    if name == "spvcnn":
        if dtype != "float32":
            raise ValueError("SPVCNN runs float32 only")
        return SPVCNN(num_classes=num_classes, cr=cr,
                      pres=cfg.dataset.voxel_size,
                      vres=cfg.dataset.voxel_size,
                      dropout_seed=(None if generator is None
                                    else generator.initial_seed()), **kw)
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
    if s == "cosine":
        # optax.cosine_decay_schedule(base_lr, num_epochs), stepped per
        # iteration as the JAX builder steps it
        n = cfg.num_epochs
        return lambda step: base_lr * 0.5 * (
            1 + math.cos(math.pi * min(step, n) / n))
    raise NotImplementedError(s)


def make_optimizer(cfg, params, lr: float) -> torch.optim.Optimizer:
    """The config's optimizer over `params`, starting at `lr` (the training
    loop sets each step's lr from the schedule)."""
    o = cfg.optimizer
    if o.name == "sgd":
        return make_sgd(params, lr, momentum=o.momentum,
                        weight_decay=o.weight_decay, nesterov=o.nesterov)
    if o.name == "adam":
        # coupled L2 before Adam (optax add_decayed_weights then
        # scale_by_adam with its default betas and eps)
        return torch.optim.Adam(params, lr=lr, weight_decay=o.weight_decay)
    if o.name == "adamw":
        # optax.adamw's defaults: decoupled decay on every parameter
        return torch.optim.AdamW(params, lr=lr, weight_decay=o.weight_decay)
    raise NotImplementedError(o.name)
