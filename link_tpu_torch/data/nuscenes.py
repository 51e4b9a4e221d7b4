"""Synthetic nuScenes-shaped frames (NumPy), for tests, training and the
chip smoke.

A copy of `SyntheticNuScenes` from `link_tpu/data/nuscenes.py` (no TTA
variants): a 200k-point frame spread over the 54 m disc of the nuScenes
detection range, voxelized at the published 0.075 x 0.075 x 0.2 m grid. In
train mode each frame also carries 5-39 random boxes of the ten classes,
drawn after the points from the same generator, and their CenterNet
targets (`det_pipeline.assign_label` at `out_size_factor`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from . import det_pipeline as dp


class SyntheticNuScenes:

    def __init__(self, length: int = 8, mode: str = "val", seed: int = 0,
                 n_points: int = 200000,
                 pc_range=(-54, -54, -5.0, 54, 54, 3.0),
                 voxel_size=(0.075, 0.075, 0.2), max_points_in_voxel=10,
                 max_voxels=120000, out_size_factor=8):
        if mode not in ("train", "val"):
            raise ValueError(f"mode must be train or val, got {mode!r}")
        self.length = length
        self.mode = mode
        self.seed = seed
        self.n_points = n_points
        self.pc_range = pc_range
        self.voxel_size = voxel_size
        self.max_points_in_voxel = max_points_in_voxel
        self.max_voxels = max_voxels
        self.out_size_factor = out_size_factor

    def __len__(self):
        return self.length

    def _draw_points(self, rng: np.random.Generator) -> np.ndarray:
        n = self.n_points
        r = np.sqrt(rng.uniform(1, 54 ** 2, n))
        th = rng.uniform(0, 2 * np.pi, n)
        z = rng.normal(-1.0, 0.8, n)
        return np.stack([r * np.cos(th), r * np.sin(th), z,
                         rng.uniform(0, 255, n), rng.uniform(0, 0.45, n)],
                        1).astype(np.float32)

    def points(self, index: int) -> np.ndarray:
        """The frame's raw (N, 5) float32 points [x y z intensity t]."""
        return self._draw_points(np.random.default_rng(self.seed + index))

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.default_rng(self.seed + index)
        pts = self._draw_points(rng)
        sample = {"token": f"synthetic_{index}"}
        if self.mode == "train":
            n_obj = rng.integers(5, 40)
            boxes = np.zeros((n_obj, 9), np.float32)
            boxes[:, 0:2] = rng.uniform(-50, 50, (n_obj, 2))
            boxes[:, 2] = rng.uniform(-1.5, 0.5, n_obj)
            boxes[:, 3:6] = rng.uniform(0.5, 4.0, (n_obj, 3))
            boxes[:, 6:8] = rng.normal(0, 2, (n_obj, 2))
            boxes[:, 8] = rng.uniform(-np.pi, np.pi, n_obj)
            classes = rng.integers(1, 11, n_obj).astype(np.int32)
            sample["targets"] = dp.assign_label(
                boxes, classes, pc_range=self.pc_range,
                voxel_size=self.voxel_size,
                out_size_factor=self.out_size_factor)
            sample["gt_boxes"] = boxes
            sample["gt_classes"] = classes
        voxels, coords_zyx, nppv = dp.points_to_voxel(
            pts, self.voxel_size, self.pc_range, self.max_points_in_voxel,
            self.max_voxels)
        sample.update({"voxels": voxels, "coords_zyx": coords_zyx,
                       "num_points": nppv})
        return sample
