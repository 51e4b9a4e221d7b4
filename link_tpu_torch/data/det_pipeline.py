"""Detection input pipeline (host side), inference part.

A copy of `link_tpu/data/det_pipeline.py`'s hard voxelizer (the native
kernel of `link_tpu_torch/native`, and its NumPy twin) and `collate_det`
with its inference fields, plus the move of a collated batch onto the
device. Reference semantics (point_cloud_ops.py:8-57):
voxels ordered by first appearance decide the truncation (the first
`max_points` points of a voxel, the first `max_voxels` voxels); the emitted
rows are then sorted into pack-key (b, z, y, x) order, the device-side
invariant the window-form plans rely on.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import native
from ..sparse.coords import INVALID_COORD

NUSC_CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer",
                "barrier", "motorcycle", "bicycle", "pedestrian",
                "traffic_cone")


def points_to_voxel(points: np.ndarray, voxel_size, pc_range,
                    max_points: int = 10, max_voxels: int = 120000,
                    impl: str = "native"):
    """Hard voxelization. Returns (voxels (V, max_points, F), coords (V, 3)
    in (z, y, x) order like the reference, num_points_per_voxel (V,)).
    impl "native" runs the C++ kernel, "numpy" the NumPy twin; both give the
    same arrays."""
    native.check_impl(impl)
    voxel_size = np.asarray(voxel_size, np.float32)
    pc_range = np.asarray(pc_range, np.float32)
    grid = np.round((pc_range[3:6] - pc_range[:3]) / voxel_size).astype(np.int32)
    if impl == "native":
        return native.voxelize_points(points, voxel_size, pc_range, grid,
                                      max_points, max_voxels)

    c = np.floor((points[:, :3] - pc_range[:3]) / voxel_size).astype(np.int32)
    keep = ((c >= 0) & (c < grid)).all(axis=1)
    pts, c = points[keep], c[keep]
    if len(pts) == 0:
        f = points.shape[1]
        return (np.zeros((0, max_points, f), np.float32),
                np.zeros((0, 3), np.int32), np.zeros((0,), np.int32))

    key = (c[:, 2].astype(np.int64) * grid[1] + c[:, 1]) * grid[0] + c[:, 0]
    uniq, first_idx, inverse = np.unique(key, return_index=True,
                                         return_inverse=True)
    appearance = np.argsort(first_idx, kind="stable")
    rank = np.empty(len(uniq), np.int64)
    rank[appearance] = np.arange(len(uniq))
    vid = rank[inverse]                      # voxel id by appearance order

    # point rank within its voxel, in point order
    order = np.argsort(vid, kind="stable")
    sorted_vid = vid[order]
    starts = np.r_[0, np.flatnonzero(np.diff(sorted_vid)) + 1]
    counts = np.diff(np.r_[starts, len(vid)])
    ranks_sorted = np.arange(len(vid)) - np.repeat(starts, counts)
    ranks = np.empty_like(ranks_sorted)
    ranks[order] = ranks_sorted

    n_vox = min(len(uniq), max_voxels)
    sel = (vid < n_vox) & (ranks < max_points)
    voxels = np.zeros((n_vox, max_points, points.shape[1]), np.float32)
    voxels[vid[sel], ranks[sel]] = pts[sel]
    nppv = np.bincount(vid[sel], minlength=n_vox).astype(np.int32)
    coords_zyx = c[first_idx[appearance[:n_vox]]][:, ::-1].astype(np.int32)

    perm = np.lexsort((coords_zyx[:, 2], coords_zyx[:, 1], coords_zyx[:, 0]))
    return voxels[perm], coords_zyx[perm], nppv[perm]


def collate_det(samples: List[Dict], voxel_capacity: int,
                max_points: int = 10, num_feats: int = 5) -> Dict:
    """Pad and batch voxelized samples: voxels / coords / num_points flat,
    coords (x, y, z, b) with INVALID_COORD padding rows."""
    vox, coor, npts = [], [], []
    for b, s in enumerate(samples):
        v, c, n = s["voxels"], s["coords_zyx"], s["num_points"]
        vox.append(v)
        coor.append(np.concatenate([c[:, ::-1],
                                    np.full((len(c), 1), b, np.int32)], 1))
        npts.append(n)
    vox = np.concatenate(vox)
    coor = np.concatenate(coor)
    npts = np.concatenate(npts)
    n = len(vox)
    if n > voxel_capacity:
        raise ValueError(f"{n} voxels > capacity {voxel_capacity}")
    out_v = np.zeros((voxel_capacity, max_points, num_feats), np.float32)
    out_c = np.full((voxel_capacity, 4), INVALID_COORD, np.int32)
    out_n = np.zeros((voxel_capacity,), np.int32)
    out_v[:n], out_c[:n], out_n[:n] = vox, coor, npts
    return {"voxels": out_v, "coords": out_c, "num_points": out_n,
            "nnz": np.int32(n)}


def det_inputs(batch: Dict, device="cuda"):
    """(voxels, coords, num_points, nnz) tensors of a collated batch on
    `device`, in the order VoxelNet.forward takes them."""
    return tuple(torch.as_tensor(np.asarray(batch[k])).to(device)
                 for k in ("voxels", "coords", "num_points", "nnz"))
