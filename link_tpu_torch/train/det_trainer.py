"""Detection training runtime: one-cycle Adam with a global-norm clip, and
the det train and predict steps.

PyTorch counterpart of `link_tpu/train/det_trainer.py` (reference:
detection/det3d/torchie/trainer/trainer.py:138-610, hooks/optimizer.py:7-22
(clip 35), solver/fastai_optim.py:121, learning_schedules_fastai.py:77-97,
apis/train.py:156-337). Data parallel with one process per replica
(`link_tpu_torch.parallel`): given a process group, the step averages the
gradients, the loss terms and the running statistics over the replicas
before `OneCycleAdam` clips and applies the averaged gradient, as JAX's
step on a mesh clips the mean.

`OneCycleAdam` runs the JAX package's optax chain in its order and with its
constants: clip by global norm, Adam whose beta1 follows the one-cycle
momentum, decoupled ("true") weight decay added to the Adam update, and the
one-cycle lr. It is written out by hand because torch's pieces differ from
optax's: `clip_grad_norm_` scales by max_norm / (norm + 1e-6) where optax
scales by exactly max_norm / norm, and `torch.optim.Adam(weight_decay=...)`
is coupled L2.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..data.det_pipeline import det_inputs, det_targets
from ..models.center_head import CODE_WEIGHTS, center_head_loss, decode_boxes
from ..models.voxelnet import map_head_maps
from ..parallel import all_reduce_mean, replica_tensors
from ..utils.profiling import LOSS_BWD, LOSS_FWD, BackwardSpan, span

# profiler ranges of one train step (`utils.profiling.span`)
RANGES = ("det_train/forward", "det_train/backward", "det_train/optimizer")


# parameters of rank >= 2 whose JAX leaf is not named 'kernel': the
# VoxelNet's z-compress conv, `extra_conv_kernel` in link_tpu/models/scn.py
NOT_KERNEL = ("backbone.extra_conv.0.weight",)


def decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """Weights-only decay mask of the bn_wd=False variant (`_decay_mask`
    decays flax's rank >= 2 leaves named 'kernel': the port's parameters of
    rank >= 2 but those of `NOT_KERNEL`); for that variant, pass
    `OneCycleAdam` the masked parameters as one group and the others as a
    group with weight_decay 0. The published recipe does not use it:
    bn_wd=True (apis/train.py:164-169) decays every parameter, BN scales
    and biases included (fastai_optim.py:158-173)."""
    return {name: p.dim() >= 2 and name not in NOT_KERNEL
            for name, p in model.named_parameters()}


class OneCycleAdam(torch.optim.Optimizer):
    """Per step, with count the number of steps taken before it (the
    chain's `make_one_cycle_adam`):

        1. g <- g if |g| < grad_clip else g / |g| * grad_clip  (global norm)
        2. b1 = mom_fn(count); m <- b1 m + (1 - b1) g; v <- b2 v + (1 - b2) g^2
           u = (m / (1 - b1^(count+1))) / (sqrt(v / (1 - b2^(count+1))) + eps)
        3. u <- u + weight_decay * p     (the group's decay: 0 off the mask)
        4. p <- p - lr_fn(count) * u

    A parameter without a gradient takes a zero one, as optax's tree does.
    The count lives in the first param group (`"count"`), so a checkpoint
    of `state_dict()` carries the one-cycle position."""

    def __init__(self, params, lr_fn: Callable[[int], float],
                 mom_fn: Callable[[int], float], weight_decay: float = 0.01,
                 grad_clip: Optional[float] = 35.0, b2: float = 0.99,
                 eps: float = 1e-8):
        super().__init__(params, dict(weight_decay=weight_decay))
        self.lr_fn, self.mom_fn = lr_fn, mom_fn
        self.grad_clip, self.b2, self.eps = grad_clip, b2, eps
        self.param_groups[0].setdefault("count", 0)

    @property
    def count(self) -> int:
        return int(self.param_groups[0]["count"])

    @torch.no_grad()
    def step(self, closure=None):
        count = self.count
        b1, b2 = float(self.mom_fn(count)), self.b2
        lr = float(self.lr_fn(count))
        params = [p for g in self.param_groups for p in g["params"]]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        if self.grad_clip is not None:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            below = norm < self.grad_clip
            # t / norm * max_norm above the edge, t itself below it
            div = torch.where(below, torch.ones_like(norm), norm)
            mul = torch.where(below, torch.ones_like(norm),
                              torch.full_like(norm, self.grad_clip))
            grads = torch._foreach_mul(torch._foreach_div(grads, div), mul)
        ms, vs = [], []
        for p in params:
            st = self.state[p]
            if not st:
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)
            ms.append(st["exp_avg"])
            vs.append(st["exp_avg_sq"])
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, grads, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, grads, grads, value=1 - b2)
        m_hat = torch._foreach_div(ms, 1 - b1 ** (count + 1))
        v_hat = torch._foreach_div(vs, 1 - b2 ** (count + 1))
        denom = torch._foreach_add(torch._foreach_sqrt(v_hat), self.eps)
        upd = torch._foreach_div(m_hat, denom)
        i = 0
        for group in self.param_groups:
            n = len(group["params"])
            if group["weight_decay"]:
                torch._foreach_add_(upd[i:i + n], group["params"],
                                    alpha=group["weight_decay"])
            i += n
        torch._foreach_add_(params, upd, alpha=-lr)
        self.param_groups[0]["count"] = count + 1
        return None


def make_one_cycle_adam(model: torch.nn.Module, lr_fn, mom_fn,
                        weight_decay: float = 0.01,
                        grad_clip: float = 35.0) -> OneCycleAdam:
    """`OneCycleAdam` over the model's parameters, every one decayed: the
    reference build's bn_wd=True."""
    return OneCycleAdam(model.parameters(), lr_fn, mom_fn,
                        weight_decay=weight_decay, grad_clip=grad_clip)


def det_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
                   batch: Dict, weight: float = 0.25,
                   code_weights=CODE_WEIGHTS,
                   group=None) -> Dict[str, torch.Tensor]:
    """One optimization step of the VoxelNet on a collated batch with
    targets (`det_pipeline.collate_det`): forward in train mode, the
    CenterHead loss, backward, `opt.step()` (`make_det_train_step`'s step).
    With `group`, a process group of replicas, the gradients, the running
    statistics and the loss terms are the replicas' means before the
    update (one all-reduce; the step on a mesh). Returns the 0-d tensors
    {loss, hm_loss_t, loc_loss_t} on the model's device."""
    model.train()
    device = next(model.parameters()).device
    with span(RANGES[0]):
        inputs = det_inputs(batch, device)
        example = det_targets(batch, device)
        opt.zero_grad(set_to_none=True)
        preds = model(*inputs)
        with span(LOSS_FWD):
            bwd = BackwardSpan(LOSS_BWD, *(v for d in preds
                                           for v in d.values()))
            if bwd.on:
                preds = map_head_maps(preds, lambda *m: bwd.xs)
            loss, logs = center_head_loss(preds, example, weight,
                                          code_weights)
            loss = bwd.out(loss)
    with span(RANGES[1]):
        loss.backward()
    metrics = {k: v.detach() for k, v in logs.items()}
    if group is not None:
        all_reduce_mean(replica_tensors(model, metrics), group)
    with span(RANGES[2]):
        opt.step()
    return metrics


def det_predict_step(model: torch.nn.Module, batch: Dict, test_cfg: Dict):
    """Forward in eval mode and decode (NMS stays outside), as
    `make_det_predict_step`."""
    model.eval()
    device = next(model.parameters()).device
    with torch.inference_mode():
        preds = model(*det_inputs(batch, device))
        return decode_boxes(preds, test_cfg, model.bbox_head.num_classes)
