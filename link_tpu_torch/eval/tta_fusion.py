"""TTA result fusion: per-class weighted rotated NMS over multiple runs.

A copy of `link_tpu/eval/tta_fusion.py`, kept here so that the port
imports nothing of the JAX package.

Reference: detection/nms_better2.py:229-332 (+ single_rot_test.sh /
fuse_rot_flip_results.sh drivers). Predictions from 7 rotations x 4 flips
(each run already double-flip-fused at predict time, center_head.py:
320-416) are concatenated per sample, NMS'd per class in GLOBAL
coordinates with per-class IoU thresholds, and capped at top-500.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..ops.nms import rotate_nms_pcdet

# nms_better2.py:89-100
NAME_TO_THRESH = {
    "traffic_cone": 0.05, "bicycle": 0.15, "bus": 0.25, "barrier": 0.1,
    "car": 0.1, "construction_vehicle": 0.1, "motorcycle": 0.1,
    "pedestrian": 0.1, "trailer": 0.1, "truck": 0.1,
}

TTA_ROT_ANGLES = (0.0, 6.25, -6.25, 12.5, -12.5, 25.0, -25.0)  # degrees


def fuse_sample(runs: List[Dict[str, np.ndarray]],
                class_names: Sequence[str], max_boxes: int = 500) -> Dict:
    """runs: per-TTA-run dicts with boxes (N, 9) [x y z w l h vx vy r],
    scores (N,), labels (N,) — all in the SAME (global or lidar) frame.
    Returns the fused dict."""
    boxes = np.concatenate([r["boxes"] for r in runs])
    scores = np.concatenate([r["scores"] for r in runs])
    labels = np.concatenate([r["labels"] for r in runs])

    keep_boxes, keep_scores, keep_labels = [], [], []
    for ci, name in enumerate(class_names):
        sel = labels == ci
        if not sel.any():
            continue
        b, s = boxes[sel], scores[sel]
        # rotate_nms expects (N, 7) [x y z w l h r]
        b7 = np.concatenate([b[:, :6], b[:, -1:]], axis=1)
        kept = rotate_nms_pcdet(b7, s, thresh=NAME_TO_THRESH.get(name, 0.1))
        keep_boxes.append(b[kept])
        keep_scores.append(s[kept])
        keep_labels.append(np.full(len(kept), ci, np.int32))

    if not keep_boxes:
        return {"boxes": np.zeros((0, 9)), "scores": np.zeros(0),
                "labels": np.zeros(0, np.int32)}
    boxes = np.concatenate(keep_boxes)
    scores = np.concatenate(keep_scores)
    labels = np.concatenate(keep_labels)
    order = np.argsort(-scores)[:max_boxes]
    return {"boxes": boxes[order], "scores": scores[order],
            "labels": labels[order]}


def rotate_predictions_back(boxes: np.ndarray, angle_rad: float) -> np.ndarray:
    """Undo a test-time input rotation (center_head.py:490-504)."""
    from ..ops.box_np import rotation_points_single_angle
    out = boxes.copy()
    out[:, :3] = rotation_points_single_angle(out[:, :3], -angle_rad, axis=2)
    if out.shape[1] > 7:
        vel3 = np.concatenate([out[:, 6:8], np.zeros((len(out), 1))], axis=1)
        out[:, 6:8] = rotation_points_single_angle(vel3, -angle_rad,
                                                   axis=2)[:, :2]
    out[:, -1] += -angle_rad
    return out
