"""Streaming mean-IoU metric.

Counterpart of `link_tpu/train/metrics.py` (reference:
segmentation/core/callbacks.py:19-98, MeanIoU): per-class total_seen /
total_correct / total_positive counters; classes never seen count as IoU 1.
"""

from __future__ import annotations

import numpy as np
import torch


def iou_counters(preds: torch.Tensor, labels: torch.Tensor,
                 valid: torch.Tensor, num_classes: int,
                 ignore_label: int = 0) -> torch.Tensor:
    """Per-class (seen, correct, positive) int32 counters for one batch,
    (3, C). Rows whose label == ignore_label are excluded, like
    callbacks.py:40-47."""
    keep = valid & (labels != ignore_label)
    cls = torch.arange(num_classes, device=preds.device)[:, None]
    is_l = (labels[None, :] == cls) & keep
    is_p = (preds[None, :] == cls) & keep
    return torch.stack([is_l.sum(1), (is_l & is_p).sum(1),
                        is_p.sum(1)]).to(torch.int32)


def miou_from_counters(counters: np.ndarray, ignore_label: int = 0) -> float:
    """callbacks.py:62-77: unseen classes contribute IoU 1; the ignore
    class is excluded from the average."""
    seen, correct, positive = counters
    ious = []
    for c in range(counters.shape[1]):
        if c == ignore_label:
            continue
        if seen[c] == 0:
            ious.append(1.0)
        else:
            union = seen[c] + positive[c] - correct[c]
            ious.append(correct[c] / max(union, 1))
    return float(np.mean(ious))


class MeanIoU:
    """Host-side accumulator of the device counters."""

    def __init__(self, num_classes: int, ignore_label: int = 0,
                 name: str = "iou/val"):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.name = name
        self.reset()

    def reset(self):
        self.counters = np.zeros((3, self.num_classes), np.int64)

    def update(self, counters) -> None:
        if isinstance(counters, torch.Tensor):
            counters = counters.cpu().numpy()
        self.counters += np.asarray(counters, np.int64)

    def compute(self) -> float:
        return miou_from_counters(self.counters, self.ignore_label)

    def per_class(self) -> np.ndarray:
        seen, correct, positive = self.counters
        union = np.maximum(seen + positive - correct, 1)
        iou = correct / union
        iou[seen == 0] = 1.0
        return iou
