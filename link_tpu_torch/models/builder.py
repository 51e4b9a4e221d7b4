"""Name-dispatched factories for the seg stack (dataset, model, criterion,
optimizer and lr schedule from a config; reference: segmentation/core/builder.py:16-124)
and the registry-driven detection builders (reference:
detection/det3d/models/builder.py + registry.py). Counterpart of
`link_tpu/models/builder.py`."""

from __future__ import annotations

import functools
import inspect
import math
from typing import Optional, Tuple

import torch

from ..data.semantic_kitti import SemanticKITTI, SyntheticSemanticKITTI
from ..nn.modules import sync_batch_norms
from ..train import losses, schedules
from ..train.trainer import make_sgd
from ..utils import registry as R
from .linkencoder import ELKEncoder
from .linkunet import DEFAULT_CAPACITIES, ELKUNet
from .minkunet import MinkUNet
from .spvcnn import SPVCNN

# seg models are registered too (the reference's torchpack builder is
# name-dispatched; the registry is the unified extension point here)
SEG_MODELS = R.Registry("seg_model")
for _cls in (ELKUNet, ELKEncoder, MinkUNet, SPVCNN):
    SEG_MODELS.register_module(_cls)
R.DATASETS.register_module(SemanticKITTI)
R.DATASETS.register_module(SyntheticSemanticKITTI)


def make_dataset(cfg, split: str = "train"):
    """The config's seg dataset (`dataset.name`): the SemanticKITTI reader
    at `dataset.root`, or "synthetic" scans (`dataset.length`, 64 when the
    config has none)."""
    name = cfg.dataset.name
    if name == "semantic_kitti":
        return SemanticKITTI(root=cfg.dataset.root, split=split,
                             voxel_size=cfg.dataset.voxel_size,
                             num_points=cfg.dataset.num_points)
    if name == "synthetic":
        return SyntheticSemanticKITTI(
            length=cfg.dataset.get("length", 64), split=split,
            voxel_size=cfg.dataset.voxel_size,
            num_points=cfg.dataset.num_points)
    raise NotImplementedError(name)


def make_model(cfg, capacities: Optional[Tuple[int, ...]] = None,
               dtype: str = "float32", device="cuda",
               generator: Optional[torch.Generator] = None,
               grid_extent=None, bn_group=None,
               remat: bool = False) -> torch.nn.Module:
    """The config's seg model. `grid_extent` reaches the models with ELK
    blocks (their dense aux path); SPVCNN runs float32 only, as the JAX
    model; its dropout rate is `model.dropout_rate` (0.3, the reference's,
    when the config has none) and is seeded from `generator`'s seed.
    `bn_group`, a process group, makes every BatchNorm a SyncBN over it
    (JAX's `bn_axis`; off by default). `remat` reaches ELKUNet, ELKEncoder
    and MinkUNet (their blocks rematerialized in training, `nn/remat.py`),
    not SPVCNN, as in the JAX builder."""
    return sync_batch_norms(_make_model(cfg, capacities, dtype, device,
                                        generator, grid_extent, remat),
                            bn_group)


def _make_model(cfg, capacities, dtype, device, generator, grid_extent,
                remat):
    m = cfg.model
    caps = tuple(capacities or m.get("capacities", DEFAULT_CAPACITIES))
    num_classes = cfg.data.num_classes
    cr = m.get("cr", 1.0)
    kw = dict(capacities=caps, device=device, generator=generator)
    name = m.name
    if name == "linkunet":
        return ELKUNet(num_classes=num_classes, cr=cr, r=m.r, s=m.s,
                       groups=m.groups, baseop=m.base_op, dtype=dtype,
                       grid_extent=grid_extent, remat=remat, **kw)
    if name == "linkencoder":
        return ELKEncoder(num_classes=num_classes, cr=cr, r=m.r, s=m.s,
                          groups=m.groups, baseop=m.base_op, dtype=dtype,
                          grid_extent=grid_extent, remat=remat, **kw)
    if name == "minkunet":
        # the default (64,) * 9 is the reference's actual plan
        # (minkunet.py:98); model.channels selects another, e.g. the stock
        # SPVNAS [32, 32, 64, 128, ...]
        if "channels" in m:
            kw["channels"] = tuple(int(c) for c in m.channels)
        return MinkUNet(num_classes=num_classes, cr=cr, dtype=dtype,
                        remat=remat, **kw)
    if name == "spvcnn":
        if dtype != "float32":
            raise ValueError("SPVCNN runs float32 only")
        return SPVCNN(num_classes=num_classes, cr=cr,
                      pres=cfg.dataset.voxel_size,
                      vres=cfg.dataset.voxel_size,
                      dropout_rate=m.get("dropout_rate", 0.3),
                      dropout_seed=(None if generator is None
                                    else generator.initial_seed()), **kw)
    # extensibility: user models registered via SEG_MODELS.register_module
    # (the port's models also take the device)
    if name in SEG_MODELS:
        return R.build_from_cfg(
            {"type": name, **{k: v for k, v in m.items()
                              if k not in ("name",)}},
            SEG_MODELS,
            default_args={"num_classes": num_classes, "capacities": caps,
                          "device": device})
    raise NotImplementedError(name)


def make_criterion(cfg):
    """The config's seg loss (`criterion.name`, `criterion.ignore_index`):
    crit(logits, labels, valid) -> (loss, {name: term}); "cross_entropy"
    alone, or "lovasz_softmax", the reference's CE + Lovász
    (`losses.segmentation_loss`)."""
    name = cfg.criterion.name
    ignore = cfg.criterion.get("ignore_index", 0)
    if name == "cross_entropy":
        def crit(logits, labels, valid):
            ce = losses.cross_entropy(logits, labels, valid, ignore)
            return ce, {"loss_ce": ce}
        return crit
    if name == "lovasz_softmax":
        return functools.partial(losses.segmentation_loss,
                                 ignore_index=ignore)
    raise NotImplementedError(name)


def register_det_builtins():
    """Register the detection components (readers / backbones / necks /
    heads / detectors / datasets) into the shared registries (reference:
    det3d/models/registry.py + each module's @register_module decorator).
    Lazy, so that seg-only use does not import the det stack."""
    from ..data.nuscenes import NuScenesDataset, SyntheticNuScenes
    from ..data.waymo import WaymoDataset
    from . import readers as RD
    from .center_head import CenterHead
    from .rpn import RPN
    from .scn import SpMiddleResNetFHDELKv3
    from .voxelnet import VoxelNet

    for reg, cls in ((R.READERS, RD.PillarFeatureNet),
                     (R.BACKBONES, SpMiddleResNetFHDELKv3),
                     (R.NECKS, RPN),
                     (R.HEADS, CenterHead),
                     (R.DETECTORS, VoxelNet),
                     (R.DATASETS, NuScenesDataset),
                     (R.DATASETS, SyntheticNuScenes),
                     (R.DATASETS, WaymoDataset)):
        if cls.__name__ not in reg:
            reg.register_module(cls)


def build_detector(model_cfg: dict, **default_args):
    """Registry-driven detector construction (reference
    det3d/models/builder.py:build_detector -> build_from_cfg). Takes a
    dict with 'type' plus constructor arguments; the keys the detector's
    constructor does not take (the nested reader / backbone / ... dicts of
    a reference config, which the module composes itself) are dropped, and
    `default_args` fill only the keys the dict lacks."""
    register_det_builtins()
    cfg = dict(model_cfg)
    obj_type = cfg.pop("type", "VoxelNet")
    cls = R.DETECTORS.get(obj_type)
    if cls is None:
        raise KeyError(f"{obj_type} not in detector registry")
    # the JAX package filters by the flax dataclass's fields; an nn.Module
    # takes its arguments through __init__
    fields = set(inspect.signature(cls.__init__).parameters) - {"self"}
    kwargs = {k: v for k, v in cfg.items() if k in fields}
    for k, v in default_args.items():
        kwargs.setdefault(k, v)
    return cls(**kwargs)


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
