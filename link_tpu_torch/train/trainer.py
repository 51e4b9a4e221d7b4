"""Segmentation training runtime: train state, train and eval steps.

PyTorch counterpart of `link_tpu/train/trainer.py` (reference:
segmentation/core/trainers.py:14-121). Data parallel with one process per
replica (`link_tpu_torch.parallel`): given a process group, the train
step averages the gradients, the loss terms and the BatchNorm running
statistics over the replicas before the update (JAX's `pmean`s), and the
eval step sums the IoU counters (`psum`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.profiler import record_function

from ..parallel import DataMesh, all_reduce_mean, replica_tensors
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
                   lr: Optional[float] = None,
                   group=None) -> Dict[str, torch.Tensor]:
    """One optimization step: forward in train mode, CE + Lovász, backward,
    SGD update (trainers.py:41-81). `lr`, when given, is this step's
    learning rate (the schedule's value). With `group`, a process group of
    replicas, the gradients, the running statistics and the loss terms are
    the replicas' means before the update (one all-reduce). Returns the
    0-d tensors {"loss", "loss_ce", "loss_lovasz"} on the model's
    device."""
    model.train()
    if lr is not None:
        for pg in opt.param_groups:
            pg["lr"] = lr
    # the ranges cost nothing outside a profiler run
    with record_function(RANGES[0]):
        st, labels, valid = _batch_on(model, batch)
        opt.zero_grad(set_to_none=True)
        logits = model(st)
        loss, aux = L.segmentation_loss(logits, labels, valid, ignore_label)
    with record_function(RANGES[1]):
        loss.backward()
    metrics = {"loss": loss.detach(),
               **{k: v.detach() for k, v in aux.items()}}
    if group is not None:
        all_reduce_mean(replica_tensors(model, metrics), group)
    with record_function(RANGES[2]):
        opt.step()
    return metrics


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


def make_dp_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
                       mesh: DataMesh, ignore_label: int = 0):
    """Stands for `make_dp_train_step`: step(batch, lr=None) trains on this
    rank's batch and averages over the mesh's replicas (`seg_train_step`
    with the mesh's group). Each replica's BatchNorm normalizes with its
    own batch's statistics (the segmentation reference trains without
    SyncBN, train.py:97-100); the running estimates are the replicas'
    mean."""

    def step(batch: Dict, lr: Optional[float] = None):
        return seg_train_step(model, opt, batch, ignore_label, lr,
                              group=mesh.group)

    return step


def make_dp_eval_step(model: torch.nn.Module, mesh: DataMesh,
                      num_classes: int, ignore_label: int = 0):
    """Stands for `make_dp_eval_step`: step(batch) -> (this rank's voxel
    predictions, the IoU counters summed over the replicas; reference
    MeanIoU all-reduce, callbacks.py:56-61). A rank whose share of the
    split has run out passes None: it adds zero counters, so that every
    rank makes the same collective calls."""

    def step(batch: Optional[Dict]):
        if batch is None:
            preds = None
            counters = torch.zeros((3, num_classes), dtype=torch.int32,
                                   device=mesh.device)
        else:
            preds, counters = seg_eval_step(model, batch, num_classes,
                                            ignore_label)
            counters = counters.clone()     # out of inference mode
        if mesh.group is not None:
            torch.distributed.all_reduce(counters, group=mesh.group)
        return preds, counters

    return step
