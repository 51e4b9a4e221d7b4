"""Detection input pipeline (host side).

A copy of `link_tpu/data/det_pipeline.py`: the hard voxelizer (the native
kernel of `link_tpu_torch/native`, and its NumPy twin), the CenterNet
training targets (`limit_period`, `gaussian_radius`, `draw_umich_gaussian`,
`assign_label`; reference preprocess.py:282-467, center_utils.py:17-63),
the train-time `global_augment`, and `collate_det` with its inference
fields and, for samples that carry `"targets"`, the per-task target fields;
plus the move of a collated batch onto the device. Voxelizer semantics
(point_cloud_ops.py:8-57):
voxels ordered by first appearance decide the truncation (the first
`max_points` points of a voxel, the first `max_voxels` voxels); the emitted
rows are then sorted into pack-key (b, z, y, x) order, the device-side
invariant the window-form plans rely on.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import native
from ..sparse.coords import INVALID_COORD

NUSC_CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer",
                "barrier", "motorcycle", "bicycle", "pedestrian",
                "traffic_cone")

NUSC_TASKS = (("car",), ("truck", "construction_vehicle"),
              ("bus", "trailer"), ("barrier",), ("motorcycle", "bicycle"),
              ("pedestrian", "traffic_cone"))
TARGET_KEYS = ("hm", "anno_box", "ind", "mask", "cat")


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


def limit_period(val, offset=0.5, period=np.pi * 2):
    return val - np.floor(val / period + offset) * period


def gaussian_radius(det_size, min_overlap=0.5, corrected: bool = False):
    """Heatmap radius, center_utils.py:17-37 bit for bit by default: the
    reference keeps CornerNet's historical `(b + sqrt) / 2` for r2 and r3
    instead of the quadratic formula's `(b + sqrt) / (2a)`, and the
    published CenterPoint recipes were trained with it. `corrected=True`
    takes the correct roots, for experiments only."""
    height, width = det_size
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1 ** 2 - 4 * c1)) / 2
    a2 = 4
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = np.sqrt(b2 ** 2 - 4 * a2 * c2)
    r2 = (b2 + sq2) / (2 * a2) if corrected else (b2 + sq2) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = np.sqrt(b3 ** 2 - 4 * a3 * c3)
    r3 = (b3 + sq3) / (2 * a3) if corrected else (b3 + sq3) / 2
    return min(r1, r2, r3)


def draw_umich_gaussian(heatmap, center, radius, k=1):
    """Splat a Gaussian of `radius` at `center` (x, y) into the (H, W)
    heatmap in place, keeping the maximum (center_utils.py:48-63)."""
    diameter = 2 * radius + 1
    m = (diameter - 1) / 2
    y, x = np.ogrid[-m:m + 1, -m:m + 1]
    sigma = diameter / 6
    g = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    g[g < np.finfo(g.dtype).eps * g.max()] = 0

    x0, y0 = int(center[0]), int(center[1])
    h, w = heatmap.shape
    left, right = min(x0, radius), min(w - x0, radius + 1)
    top, bottom = min(y0, radius), min(h - y0, radius + 1)
    if right + left <= 0 or bottom + top <= 0:
        return heatmap
    mh = heatmap[y0 - top:y0 + bottom, x0 - left:x0 + right]
    mg = g[radius - top:radius + bottom, radius - left:radius + right]
    np.maximum(mh, mg * k, out=mh)
    return heatmap


def assign_label(gt_boxes: np.ndarray, gt_classes: np.ndarray,
                 tasks: Sequence[Sequence[str]] = NUSC_TASKS,
                 class_names: Sequence[str] = NUSC_CLASSES,
                 pc_range=(-54, -54, -5.0, 54, 54, 3.0),
                 voxel_size=(0.075, 0.075, 0.2), out_size_factor: int = 8,
                 gaussian_overlap: float = 0.1, max_objs: int = 500,
                 min_radius: int = 2) -> Dict[str, List[np.ndarray]]:
    """CenterNet target maps (preprocess.py:282-467). gt_boxes (N, 9)
    [x y z w l h vx vy rot], gt_classes 1-based global class ids. Per task:
    hm (H, W, C) (channels last, as the losses read the head maps), anno_box
    (max_objs, 10) [dx dy z log(w l h) vx vy sin cos], ind (max_objs,) the
    centre cell y * W + x, mask and cat (the class within the task)."""
    pc_range = np.asarray(pc_range, np.float32)
    voxel_size = np.asarray(voxel_size, np.float32)
    grid = np.round((pc_range[3:6] - pc_range[:3])
                    / voxel_size).astype(np.int64)
    fw, fh = grid[0] // out_size_factor, grid[1] // out_size_factor

    example = {k: [] for k in TARGET_KEYS}
    for tnames in tasks:
        gids = [class_names.index(n) + 1 for n in tnames]
        sel = np.isin(gt_classes, gids)
        boxes = gt_boxes[sel]
        local = np.array([gids.index(g) for g in gt_classes[sel]], np.int64)

        hm = np.zeros((fh, fw, len(tnames)), np.float32)
        anno_box = np.zeros((max_objs, 10), np.float32)
        ind = np.zeros((max_objs,), np.int64)
        mask = np.zeros((max_objs,), np.uint8)
        cat = np.zeros((max_objs,), np.int64)

        boxes = boxes.copy()
        if len(boxes):
            boxes[:, -1] = limit_period(boxes[:, -1], 0.5, np.pi * 2)
        for k in range(min(len(boxes), max_objs)):
            w, l = boxes[k, 3] / voxel_size[0] / out_size_factor, \
                   boxes[k, 4] / voxel_size[1] / out_size_factor
            if w <= 0 or l <= 0:
                continue
            radius = max(min_radius,
                         int(gaussian_radius((l, w), gaussian_overlap)))
            x, y, z = boxes[k, 0], boxes[k, 1], boxes[k, 2]
            cx = (x - pc_range[0]) / voxel_size[0] / out_size_factor
            cy = (y - pc_range[1]) / voxel_size[1] / out_size_factor
            ct = np.array([cx, cy], np.float32)
            ci = ct.astype(np.int32)
            if not (0 <= ci[0] < fw and 0 <= ci[1] < fh):
                continue
            draw_umich_gaussian(hm[:, :, local[k]], ct, radius)
            cat[k] = local[k]
            ind[k] = ci[1] * fw + ci[0]
            mask[k] = 1
            vx, vy, rot = boxes[k, 6], boxes[k, 7], boxes[k, 8]
            anno_box[k] = np.concatenate([
                ct - ci, [z], np.log(boxes[k, 3:6]), [vx, vy],
                [np.sin(rot), np.cos(rot)]])

        for key, v in zip(TARGET_KEYS, (hm, anno_box, ind, mask, cat)):
            example[key].append(v)
    return example


def global_augment(points: np.ndarray, gt_boxes: np.ndarray,
                   rng: np.random.Generator,
                   rot_noise=(-np.pi / 4, np.pi / 4),
                   scale_noise=(0.9, 1.1), translate_std: float = 0.5):
    """Train-time global flip, rotation, scale and translation
    (preprocess.py:118-136). Boxes (N, 9) [x y z w l h vx vy r] with the
    det3d yaw convention; the flip and rotation updates are the reference's
    (prep.random_flip_both preprocess.py:803-832, prep.global_rotation
    preprocess.py:771-788). Draws from `rng` in the reference's order."""
    points = points.copy()
    gt_boxes = gt_boxes.copy()

    if rng.random() < 0.5:                      # flip y
        points[:, 1] = -points[:, 1]
        if len(gt_boxes):
            gt_boxes[:, 1] = -gt_boxes[:, 1]
            gt_boxes[:, 8] = -gt_boxes[:, 8] + np.pi
            gt_boxes[:, 7] = -gt_boxes[:, 7]
    if rng.random() < 0.5:                      # flip x
        points[:, 0] = -points[:, 0]
        if len(gt_boxes):
            gt_boxes[:, 0] = -gt_boxes[:, 0]
            gt_boxes[:, 8] = -gt_boxes[:, 8] + 2 * np.pi
            gt_boxes[:, 6] = -gt_boxes[:, 6]

    theta = rng.uniform(*rot_noise)
    c, s = np.cos(theta), np.sin(theta)
    # the reference's sense: points @ rot_mat_T with rot_mat_T = [[c, -s],
    # [s, c]] while yaw += theta (box_np_ops.py:182-204)
    rot_mat_T = np.array([[c, -s], [s, c]], np.float32)
    points[:, :2] = points[:, :2] @ rot_mat_T
    if len(gt_boxes):
        gt_boxes[:, :2] = gt_boxes[:, :2] @ rot_mat_T
        gt_boxes[:, 6:8] = gt_boxes[:, 6:8] @ rot_mat_T
        gt_boxes[:, 8] += theta

    scale = rng.uniform(*scale_noise)
    points[:, :3] *= scale
    if len(gt_boxes):
        gt_boxes[:, :6] *= scale
        gt_boxes[:, 6:8] *= scale

    t = rng.normal(0, translate_std, 3).astype(np.float32)
    points[:, :3] += t
    if len(gt_boxes):
        gt_boxes[:, :3] += t
    return points, gt_boxes


def collate_det(samples: List[Dict], voxel_capacity: int,
                max_points: int = 10, num_feats: int = 5) -> Dict:
    """Pad and batch voxelized samples: voxels / coords / num_points flat,
    coords (x, y, z, b) with INVALID_COORD padding rows. Samples that carry
    `"targets"` (assign_label's dict) add the target fields, each a list
    over the tasks of arrays stacked over the batch."""
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
    batch = {"voxels": out_v, "coords": out_c, "num_points": out_n,
             "nnz": np.int32(n)}
    if "targets" in samples[0]:
        tasks = len(samples[0]["targets"]["hm"])
        for key in TARGET_KEYS:
            batch[key] = [np.stack([s["targets"][key][t] for s in samples])
                          for t in range(tasks)]
    return batch


def det_inputs(batch: Dict, device="cuda"):
    """(voxels, coords, num_points, nnz) tensors of a collated batch on
    `device`, in the order VoxelNet.forward takes them."""
    return tuple(torch.as_tensor(batch[k]).to(device)
                 for k in ("voxels", "coords", "num_points", "nnz"))


def det_targets(batch: Dict, device="cuda") -> Dict[str, List[torch.Tensor]]:
    """The target fields of a collated batch on `device`, per task: hm,
    anno_box and mask (0 / 1) float32, ind and cat int64."""
    out = {}
    for key in TARGET_KEYS:
        dt = (torch.float32 if key in ("hm", "anno_box", "mask")
              else torch.long)
        out[key] = [torch.as_tensor(v).to(device=device, dtype=dt)
                    for v in batch[key]]
    return out
