"""GT-AUG: paste-sampling from a ground-truth database, and the database.

A copy of `link_tpu/data/gt_aug.py` (reference detection/det3d/core/sampler/
sample_ops.py:13-369 DataBaseSamplerV2 with the preprocess.py db_prep
filters, and det3d/datasets/utils/create_gt_database.py:16): per-class
sample groups (car 2, truck 3, ...), candidates rejected when their BEV box
meets an existing or an already sampled box, point clusters read from the
database (stored box-centred) and moved to their box centres.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ops import box_np

DEFAULT_SAMPLE_GROUPS = dict(car=2, truck=3, construction_vehicle=7, bus=4,
                             trailer=6, barrier=2, motorcycle=6, bicycle=6,
                             pedestrian=2, traffic_cone=2)
DEFAULT_MIN_POINTS = {k: 5 for k in DEFAULT_SAMPLE_GROUPS}


class DataBaseSampler:
    def __init__(self, db_info_path: str, root_path: str = "",
                 sample_groups: Dict[str, int] = None,
                 min_points: Dict[str, int] = None, rate: float = 1.0,
                 num_point_features: int = 5):
        with open(db_info_path, "rb") as f:
            db_infos = pickle.load(f)
        self.root_path = root_path
        self.rate = rate
        self.num_point_features = num_point_features
        self.sample_groups = sample_groups or DEFAULT_SAMPLE_GROUPS
        min_points = min_points or DEFAULT_MIN_POINTS
        # db_prep: filter_by_min_num_points + filter_by_difficulty([-1])
        self.db_infos = {}
        for cls, infos in db_infos.items():
            kept = [i for i in infos
                    if i.get("num_points_in_gt", 1 << 30) >= min_points.get(cls, 0)
                    and i.get("difficulty", 0) != -1]
            if kept:
                self.db_infos[cls] = kept

    def _load_points(self, info: Dict) -> np.ndarray:
        path = os.path.join(self.root_path, info["path"])
        pts = np.fromfile(path, np.float32).reshape(
            -1, self.num_point_features)
        pts = pts.copy()
        pts[:, :3] += np.asarray(info["box3d_lidar"][:3], np.float32)
        return pts

    def sample_all(self, gt_boxes: np.ndarray, gt_names: np.ndarray,
                   rng: Optional[np.random.Generator] = None
                   ) -> Optional[Dict]:
        gen = rng or np.random.default_rng()
        sampled_infos: List[Dict] = []
        sampled_boxes: List[np.ndarray] = []

        def bev5(b):
            # (x, y, w, l, r) — gt boxes are (N, 9) with rot last
            return np.stack([b[:, 0], b[:, 1], b[:, 3], b[:, 4], b[:, -1]], 1)

        avoid = bev5(gt_boxes) if len(gt_boxes) else np.zeros((0, 5))

        for cls, max_num in self.sample_groups.items():
            if cls not in self.db_infos:
                continue
            n_exist = int(np.sum(gt_names == cls))
            n_sample = int(self.rate * max(0, max_num - n_exist))
            if n_sample == 0:
                continue
            pool = self.db_infos[cls]
            picks = gen.choice(len(pool), min(n_sample, len(pool)),
                               replace=False)
            for p in picks:
                info = pool[p]
                box = np.asarray(info["box3d_lidar"], np.float32)
                if box.shape[0] == 7:
                    box = np.concatenate(
                        [box[:6], [0.0, 0.0], box[6:]]).astype(np.float32)
                cand = bev5(box[None])
                if len(avoid) and (box_np.boxes_bev_iou(cand, avoid) > 0).any():
                    continue
                avoid = np.concatenate([avoid, cand])
                sampled_infos.append(info)
                sampled_boxes.append(box)

        if not sampled_infos:
            return None
        points = np.concatenate(
            [self._load_points(i) for i in sampled_infos])
        return {
            "gt_names": np.asarray([i["name"] for i in sampled_infos]),
            "gt_boxes": np.stack(sampled_boxes),
            "points": points.astype(np.float32),
            "gt_masks": np.ones(len(sampled_infos), bool),
        }


def create_gt_database(dataset, out_dir: str, num_point_features: int = 5):
    """Build a gt database from any dataset yielding points + gt boxes
    (reference: det3d/datasets/utils/create_gt_database.py:16). Points are
    stored box-centered."""
    os.makedirs(os.path.join(out_dir, "gt_database"), exist_ok=True)
    db_infos: Dict[str, List[Dict]] = {}
    for idx in range(len(dataset)):
        s = dataset[idx]
        points, boxes, classes = s["points"], s["gt_boxes"], s["gt_names"]
        mask = box_np.points_in_rbbox(points, boxes)
        for j, name in enumerate(classes):
            pts = points[mask[:, j]].copy()
            pts[:, :3] -= boxes[j, :3]
            fn = f"gt_database/{idx}_{name}_{j}.bin"
            pts.astype(np.float32).tofile(os.path.join(out_dir, fn))
            db_infos.setdefault(name, []).append({
                "name": name, "path": fn, "box3d_lidar": boxes[j],
                "num_points_in_gt": int(mask[:, j].sum()),
                "difficulty": 0,
            })
    with open(os.path.join(out_dir, "dbinfos_train.pkl"), "wb") as f:
        pickle.dump(db_infos, f)
    return db_infos
