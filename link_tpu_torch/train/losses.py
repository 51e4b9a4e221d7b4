"""Segmentation losses: masked cross-entropy + sort-form Lovász-softmax.

PyTorch counterpart of `link_tpu/train/losses.py` (reference:
segmentation/core/trainers.py:64-73, loss = CE(ignore 0) +
lovasz_softmax(softmax(out), targets, ignore=0), and the Berman Lovász
implementation, segmentation/core/lovasz_losses.py:156-202).

Padded rows are folded into the ignored set. For Lovász this is exact:
masked rows get error 0, sort to the tail of the descending error list, and
the Lovász gradient is a prefix property, so trailing zero-error rows
contribute nothing.
"""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor, ignore_index: int = 0) -> torch.Tensor:
    """Mean NLL over the valid rows with label != ignore_index (torch
    CrossEntropyLoss(ignore_index) semantics)."""
    keep = valid & (labels != ignore_index)
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    nll = -lp.gather(1, safe[:, None])[:, 0]
    w = keep.to(torch.float32)
    return (nll * w).sum() / w.sum().clamp(min=1.0)


def _lovasz_grad_from_sorted(fg_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension w.r.t. the sorted errors, along the
    last dim (lovasz_losses.py:21-32)."""
    gts = fg_sorted.sum(-1, keepdim=True)
    intersection = gts - fg_sorted.cumsum(-1)
    union = gts + (1.0 - fg_sorted).cumsum(-1)
    jaccard = 1.0 - intersection / union.clamp(min=1e-12)
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]],
                     dim=-1)


def lovasz_softmax(probas: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor, ignore_index: int = 0) -> torch.Tensor:
    """classes='present' Lovász-softmax over (N, C) probabilities
    (lovasz_losses.py:174-202), all classes at once as rows of (C, N).

    dot(errors_sorted, lovasz_grad) == dot(errors, w) with w the Lovász
    gradient routed back to input order. The permutation comes from one
    stable sort of the detached errors (ties fall as in the JAX package's
    stable `lax.sort`), and the gradient flows only through the final
    product: d_errors = w, elementwise."""
    n, c = probas.shape
    keep = (valid & (labels != ignore_index)).to(torch.float32)
    cls = torch.arange(c, device=probas.device)
    fg = (labels[None, :] == cls[:, None]).to(torch.float32) * keep
    errors = (fg - probas.T).abs() * keep                       # (C, N)
    order = torch.sort(-errors.detach(), dim=1, stable=True).indices
    grad = _lovasz_grad_from_sorted(fg.gather(1, order))
    w = torch.empty_like(grad).scatter_(1, order, grad)   # w[j] = grad@rank(j)
    present = (fg.sum(1) > 0).to(torch.float32)
    losses = (errors * w).sum(1) * present
    return losses.sum() / present.sum().clamp(min=1.0)


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor,
                      valid: torch.Tensor, ignore_index: int = 0):
    """CE + Lovász as combined in SemanticKITTITrainer._run_step. Returns
    (loss, {"loss_ce", "loss_lovasz"})."""
    ce = cross_entropy(logits, labels, valid, ignore_index)
    probas = torch.softmax(logits.to(torch.float32), dim=-1)
    lov = lovasz_softmax(probas, labels, valid, ignore_index)
    return ce + lov, {"loss_ce": ce, "loss_lovasz": lov}
