"""nuScenes submission JSON writer.

A copy of `link_tpu/eval/submission.py`, kept here so that the port
imports nothing of the JAX package.

Reference: detection/det3d/datasets/nuscenes/nuscenes.py:208-347
(_lidar_nusc_box_to_global conversion + attribute heuristics by velocity +
official results JSON schema).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.det_pipeline import NUSC_CLASSES

# nuscenes.py:260-292 attribute heuristic
DEFAULT_ATTR = {
    "car": "vehicle.parked",
    "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked",
    "truck": "vehicle.parked",
    "bus": "vehicle.moving",
    "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider",
    "barrier": "",
    "traffic_cone": "",
}


def _attr_for(name: str, velocity: np.ndarray) -> str:
    if np.sqrt(velocity[0] ** 2 + velocity[1] ** 2) > 0.2:
        if name in ("car", "construction_vehicle", "bus", "truck", "trailer"):
            return "vehicle.moving"
        if name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
    return DEFAULT_ATTR[name]


def _yaw_to_quaternion(yaw: float):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def det3d_to_devkit_yaw(boxes: np.ndarray) -> np.ndarray:
    """Undo the det3d yaw convention before anything devkit-facing:
    yaw_devkit = -yaw_det3d - pi/2 (reference _second_det_to_nusc_box,
    nusc_common.py:160-178, mirroring the forward conversion at
    nusc_common.py:505). boxes (N, 9) -> copy with devkit yaw."""
    out = boxes.copy()
    out[:, 8] = -out[:, 8] - np.pi / 2
    return out


def boxes_lidar_to_global(boxes: np.ndarray, info: Dict) -> np.ndarray:
    """Invert the info's global->lidar chain (nusc_common.py:181-214).
    boxes (N, 9) in lidar frame -> global frame. Yaw must already be in
    the standard devkit convention (use det3d_to_devkit_yaw first for
    model outputs): the additive yaw_shift below is only valid for a
    standard CCW yaw."""
    car_from_ref = np.linalg.inv(info["ref_from_car"])
    global_from_car = np.linalg.inv(info["car_from_global"])
    tm = global_from_car @ car_from_ref
    out = boxes.copy()
    xyz1 = np.concatenate([boxes[:, :3], np.ones((len(boxes), 1))], axis=1)
    out[:, :3] = (xyz1 @ tm.T)[:, :3]
    rot = tm[:3, :3]
    vel3 = np.concatenate([boxes[:, 6:8], np.zeros((len(boxes), 1))], axis=1)
    out[:, 6:8] = (vel3 @ rot.T)[:, :2]
    yaw_shift = np.arctan2(rot[1, 0], rot[0, 0])
    out[:, 8] = boxes[:, 8] + yaw_shift
    return out


def write_submission(samples: List[Dict], out_path: str,
                     infos: Optional[Dict[str, Dict]] = None,
                     class_names: Sequence[str] = NUSC_CLASSES) -> str:
    """samples: dicts with token, pred_boxes (N, 9) [x y z w l h vx vy yaw]
    with yaw in the det3d convention (model-output frame), pred_scores,
    pred_labels (global ids). Yaw is converted back to the devkit
    convention first (nusc_common.py:164); when `infos` (token -> info) is
    given, boxes are then converted to the global frame."""
    results = {}
    for s in samples:
        token = s["token"]
        boxes = np.asarray(s["pred_boxes"], np.float64)
        boxes = det3d_to_devkit_yaw(boxes)
        if infos is not None and token in infos:
            boxes = boxes_lidar_to_global(boxes, infos[token])
        annos = []
        for b, score, label in zip(boxes, s["pred_scores"],
                                   s["pred_labels"]):
            name = class_names[int(label)]
            annos.append({
                "sample_token": token,
                "translation": [float(v) for v in b[:3]],
                "size": [float(v) for v in b[3:6]],
                "rotation": _yaw_to_quaternion(float(b[8])),
                "velocity": [float(b[6]), float(b[7])],
                "detection_name": name,
                "detection_score": float(score),
                "attribute_name": _attr_for(name, b[6:8]),
            })
        results[token] = annos

    sub = {
        "results": results,
        "meta": {
            "use_camera": False, "use_lidar": True, "use_radar": False,
            "use_map": False, "use_external": False,
        },
    }
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(sub, f)
    return out_path
