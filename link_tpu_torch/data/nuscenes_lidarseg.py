"""nuScenes-lidarseg semantic segmentation dataset, host-side NumPy.

A copy of `link_tpu/data/nuscenes_lidarseg.py` (reference
segmentation/core/datasets/nuscenes.py:95-365, nuScenesInternal), kept here
so the port imports nothing of the JAX package: devkit scene iteration,
lidarseg .bin labels remapped 32 -> 16 classes + noise, voxel 0.15 m, the
same aug/quantize structure as SemanticKITTI. Requires the nuscenes-devkit
for raw-data iteration (gated import); the processing path
(`process_scan`) is the port's `semantic_kitti.py`'s.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from .semantic_kitti import process_scan

# nuscenes.py:52-85 lidarseg learning map (32 raw -> 16 + noise)
LEARNING_MAP = {
    1: 0, 5: 0, 7: 0, 8: 0, 10: 0, 11: 0, 13: 0, 19: 0, 20: 0, 0: 0,
    29: 0, 31: 0, 9: 1, 14: 2, 15: 3, 16: 3, 17: 4, 18: 5, 21: 6, 2: 7,
    3: 7, 4: 7, 6: 7, 12: 8, 22: 9, 23: 10, 24: 11, 25: 12, 26: 13,
    27: 14, 28: 15, 30: 16,
}

CLASS_NAMES = [
    "noise", "barrier", "bicycle", "bus", "car", "construction_vehicle",
    "motorcycle", "pedestrian", "traffic_cone", "trailer", "truck",
    "driveable_surface", "other_flat", "sidewalk", "terrain", "manmade",
    "vegetation",
]

NUM_CLASSES = 17
IGNORE_LABEL = 0


def build_label_map() -> np.ndarray:
    lut = np.full(260, 255, np.int64)
    for k, v in LEARNING_MAP.items():
        lut[k] = v
    return lut


class NuScenesLidarSeg:
    def __init__(self, root: str, split: str = "train",
                 voxel_size: float = 0.15, num_points: int = 80000,
                 sample_stride: int = 1, version: Optional[str] = None):
        try:
            from nuscenes import NuScenes
            from nuscenes.utils import splits
        except ImportError as e:
            raise ImportError(
                "nuscenes-devkit required for nuScenes-lidarseg") from e

        if version is None:
            version = "v1.0-test" if split == "test" else "v1.0-trainval"
        scenes = {"train": splits.train, "val": splits.val,
                  "test": splits.test}[split]
        self.nusc = NuScenes(version=version, dataroot=root, verbose=False)
        self.root = root
        self.split = split
        self.voxel_size = voxel_size
        self.num_points = num_points
        self.label_map = build_label_map()

        scene_tokens = {s["token"] for s in self.nusc.scene
                        if s["name"] in scenes}
        self.tokens: List[str] = []
        for sample in self.nusc.sample:
            if sample["scene_token"] in scene_tokens:
                self.tokens.append(sample["data"]["LIDAR_TOP"])
        if sample_stride > 1:
            self.tokens = self.tokens[::sample_stride]

    def __len__(self):
        return len(self.tokens)

    def __getitem__(self, index: int, rng=None) -> Dict:
        sd_token = self.tokens[index]
        sd = self.nusc.get("sample_data", sd_token)
        path = os.path.join(self.root, sd["filename"])
        raw = np.fromfile(path, np.float32).reshape(-1, 5)
        points = raw[:, :4]

        if self.split != "test":
            seg_path = os.path.join(
                self.root, self.nusc.get("lidarseg", sd_token)["filename"])
            labels = self.label_map[np.fromfile(seg_path, np.uint8)]
        else:
            labels = np.zeros(len(points), np.int64)

        out = process_scan(points, labels, self.voxel_size, self.num_points,
                           self.split == "train", rng)
        out["file_name"] = path
        return out
