"""Segmentation training runtime: train state, train and eval steps.

PyTorch counterpart of `link_tpu/train/trainer.py` (reference:
segmentation/core/trainers.py:14-121), single device: no mesh and no data
parallelism.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.profiler import record_function

from ..sparse.tensor import make_sparse_tensor
from . import losses as L
from .metrics import iou_counters


# profiler ranges of one train step (torch.profiler.record_function)
RANGES = ("seg_train/forward", "seg_train/backward", "seg_train/optimizer")


def make_sgd(params, lr: float, momentum: float = 0.9,
             weight_decay: float = 1e-4,
             nesterov: bool = True) -> torch.optim.SGD:
    """torch.optim.SGD as the reference builds it (builder.py:80-86):
    coupled weight decay added to the gradient, then (nesterov) momentum,
    then lr. `link_tpu`'s optax chain reproduces exactly this."""
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           weight_decay=weight_decay, nesterov=nesterov)


class TrainState:
    """What a checkpoint holds: the step count, the model's parameters and
    batch statistics, and the optimizer's state."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.step = step

    def state_dict(self) -> Dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, sd: Dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])


def _batch_on(model: torch.nn.Module, batch: Dict):
    """The collated batch as a SparseTensor, its labels and its valid-row
    mask, on the model's device."""
    device = next(model.parameters()).device
    st = make_sparse_tensor(batch["feats"], batch["coords"], nnz=batch["nnz"],
                            base_sorted=True, device=device)
    labels = torch.as_tensor(batch["labels"]).to(device)
    valid = torch.arange(st.capacity, device=device) < st.nnz
    return st, labels, valid


def seg_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
                   batch: Dict, ignore_label: int = 0,
                   lr: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """One optimization step: forward in train mode, CE + Lovász, backward,
    SGD update (trainers.py:41-81). `lr`, when given, is this step's
    learning rate (the schedule's value). Returns the 0-d tensors
    {"loss", "loss_ce", "loss_lovasz"} on the model's device."""
    model.train()
    if lr is not None:
        for group in opt.param_groups:
            group["lr"] = lr
    # the ranges cost nothing outside a profiler run
    with record_function(RANGES[0]):
        st, labels, valid = _batch_on(model, batch)
        opt.zero_grad(set_to_none=True)
        logits = model(st)
        loss, aux = L.segmentation_loss(logits, labels, valid, ignore_label)
    with record_function(RANGES[1]):
        loss.backward()
    with record_function(RANGES[2]):
        opt.step()
    return {"loss": loss.detach(),
            **{k: v.detach() for k, v in aux.items()}}


def seg_eval_step(model: torch.nn.Module, batch: Dict, num_classes: int,
                  ignore_label: int = 0):
    """Voxel-level predictions (N,) int32 and the (3, C) IoU counters
    (trainers.py:84-103 computes point-level through the inverse map; that
    remap happens on the host)."""
    model.eval()
    with torch.inference_mode():
        st, labels, valid = _batch_on(model, batch)
        preds = model(st).argmax(-1).to(torch.int32)
        counters = iou_counters(preds, labels, valid, num_classes,
                                ignore_label)
    return preds, counters
