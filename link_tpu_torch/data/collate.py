"""Fixed-capacity batch collation (numpy), and the move onto the device.

A copy of `collate_scans` from `link_tpu/data/collate.py`: scans are
concatenated with a batch-index column appended to coords, then padded to a
static capacity. Padding coords use the INVALID sentinel; padding labels use
the ignore label.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..sparse.coords import INVALID_COORD
from ..sparse.tensor import SparseTensor, make_sparse_tensor


def collate_scans(scans: List[Dict], capacity: int,
                  point_capacity: Optional[int] = None,
                  ignore_label: int = 0,
                  grid_extent=None) -> Dict[str, np.ndarray]:
    """`grid_extent=(nx, ny, nz[, nb])` drops voxels at coords outside
    [0, extent), keeping the device-side domain bound unconditional."""
    coords, feats, labels = [], [], []
    dropped = 0
    for b, scan in enumerate(scans):
        c = scan["coords"]
        f, lab = scan["feats"], scan["labels"]
        if grid_extent is not None:
            e = np.asarray(grid_extent[:3], np.int32)
            keep = ((c[:, :3] >= 0) & (c[:, :3] < e)).all(axis=1)
            if not keep.all():
                dropped += int((~keep).sum())
                c, f, lab = c[keep], f[keep], lab[keep]
        coords.append(np.concatenate(
            [c, np.full((len(c), 1), b, np.int32)], axis=1))
        feats.append(f)
        labels.append(lab)
    if dropped and point_capacity is not None:
        # the point-level inverse maps index voxel rows by position
        raise ValueError(
            f"{dropped} voxels outside grid_extent {grid_extent} in a "
            "point-level (eval) batch; raise the extent for this dataset")
    coords = np.concatenate(coords)
    feats = np.concatenate(feats)
    labels = np.concatenate(labels)
    n = len(coords)
    if n > capacity:
        raise ValueError(f"batch voxel count {n} exceeds capacity {capacity}")

    out_c = np.full((capacity, 4), INVALID_COORD, np.int32)
    out_f = np.zeros((capacity, feats.shape[1]), np.float32)
    out_l = np.full((capacity,), ignore_label, np.int32)
    out_c[:n], out_f[:n], out_l[:n] = coords, feats, labels

    batch = {"coords": out_c, "feats": out_f, "labels": out_l,
             "nnz": np.int32(n)}

    if point_capacity is not None:
        pl = np.full((point_capacity,), -1, np.int32)
        inv = np.full((point_capacity,), -1, np.int32)
        pt = 0
        voxel_off = 0
        for scan in scans:
            npnt = len(scan["point_labels"])
            if pt + npnt > point_capacity:
                raise ValueError("point capacity exceeded")
            pl[pt:pt + npnt] = scan["point_labels"]
            inv[pt:pt + npnt] = scan["inverse_map"] + voxel_off
            pt += npnt
            voxel_off += len(scan["coords"])
        batch["point_labels"] = pl
        batch["point_inverse"] = inv
        batch["num_points"] = np.int32(pt)
    return batch


def to_sparse_tensor(batch: Dict[str, np.ndarray], device="cuda",
                     grid_extent=None) -> SparseTensor:
    """Put a collated batch on `device` as a SparseTensor (coords in
    pack-key order, as collate_scans emits them)."""
    return make_sparse_tensor(batch["feats"], batch["coords"],
                              nnz=batch["nnz"], base_sorted=True,
                              grid_extent=grid_extent, device=device)


def level_unique_counts(coords: np.ndarray, levels: int) -> List[int]:
    """Exact unique-voxel counts at strides 1, 2, 4, ... (floor-division
    lattice, as spdownsample's fast path). coords (N, 4) with the batch
    column last. A copy of `link_tpu/data/collate.py:level_unique_counts`."""
    out = []
    c = coords.astype(np.int64)
    for lvl in range(levels):
        s = 1 << lvl
        d = np.unique(np.concatenate([c[:, :3] // s, c[:, 3:]], 1), axis=0)
        out.append(len(d))
    return out


def audit_capacities(coords: np.ndarray, capacities) -> List[int]:
    """Per-level voxel-overflow counts of one batch against a capacity
    schedule. The device path (`coords.unique_coords`) clamps silently;
    this host-side audit makes the drops observable."""
    counts = level_unique_counts(coords, len(capacities))
    return [max(0, n - int(cap)) for n, cap in zip(counts, capacities)]
