"""Synthetic nuScenes-shaped frames (NumPy), for tests and the chip smoke.

A copy of `SyntheticNuScenes` from `link_tpu/data/nuscenes.py` (the
val-mode fields: no targets, no TTA variants): a 200k-point frame spread
over the 54 m disc of the nuScenes detection range, voxelized at the
published 0.075 x 0.075 x 0.2 m grid.
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
                 max_voxels=120000):
        if mode == "train":
            raise NotImplementedError("training targets are not ported")
        self.length = length
        self.mode = mode
        self.seed = seed
        self.n_points = n_points
        self.pc_range = pc_range
        self.voxel_size = voxel_size
        self.max_points_in_voxel = max_points_in_voxel
        self.max_voxels = max_voxels

    def __len__(self):
        return self.length

    def points(self, index: int) -> np.ndarray:
        """The frame's raw (N, 5) float32 points [x y z intensity t]."""
        rng = np.random.default_rng(self.seed + index)
        n = self.n_points
        r = np.sqrt(rng.uniform(1, 54 ** 2, n))
        th = rng.uniform(0, 2 * np.pi, n)
        z = rng.normal(-1.0, 0.8, n)
        return np.stack([r * np.cos(th), r * np.sin(th), z,
                         rng.uniform(0, 255, n), rng.uniform(0, 0.45, n)],
                        1).astype(np.float32)

    def __getitem__(self, index: int) -> Dict:
        voxels, coords_zyx, nppv = dp.points_to_voxel(
            self.points(index), self.voxel_size, self.pc_range,
            self.max_points_in_voxel, self.max_voxels)
        return {"token": f"synthetic_{index}", "voxels": voxels,
                "coords_zyx": coords_zyx, "num_points": nppv}
