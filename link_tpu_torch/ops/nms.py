"""Host rotated NMS (NumPy).

A copy of the NumPy branch of `link_tpu/ops/nms.py:rotate_nms_pcdet`
(reference core/bbox/box_torch_ops.py:248-276 over iou3d_nms): score-sorted
greedy suppression by BEV rotated IoU, on the decoded candidates that
leave the device, as the reference splits decode and NMS.
"""

from __future__ import annotations

import numpy as np

from .box_np import center_to_corner_box2d, rotated_box_overlap


def rotate_nms_pcdet(boxes: np.ndarray, scores: np.ndarray,
                     thresh: float, pre_maxsize: int = None,
                     post_max_size: int = None) -> np.ndarray:
    """boxes (N, 7) [x y z w l h r]; returns kept indices into the input
    order, score-descending."""
    order = np.argsort(-scores, kind="stable")
    if pre_maxsize is not None:
        order = order[:pre_maxsize]
    b = boxes[order]
    n = len(b)
    if n == 0:
        return np.zeros((0,), np.int64)
    corners = center_to_corner_box2d(b[:, :2], b[:, 3:5], b[:, 6])
    areas = b[:, 3] * b[:, 4]
    rad = 0.5 * np.hypot(b[:, 3], b[:, 4])
    suppressed = np.zeros(n, bool)
    keep = []
    for i in range(n):
        if suppressed[i]:
            continue
        keep.append(i)
        if post_max_size is not None and len(keep) >= post_max_size:
            break
        # circumscribed-circle reject before the polygon clip
        d = np.hypot(b[i + 1:, 0] - b[i, 0], b[i + 1:, 1] - b[i, 1])
        cand = np.flatnonzero((d <= rad[i] + rad[i + 1:])
                              & ~suppressed[i + 1:]) + i + 1
        for j in cand:
            inter = rotated_box_overlap(corners[i], corners[j])
            union = areas[i] + areas[j] - inter
            if union > 0 and inter / union > thresh:
                suppressed[j] = True
    return order[np.asarray(keep, np.int64)]
