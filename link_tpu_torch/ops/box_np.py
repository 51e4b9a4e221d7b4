"""NumPy box math (host-side NMS, data preparation, evaluation).

A copy of `link_tpu/ops/box_np.py` (reference det3d/core/bbox/
box_np_ops.py): period limiting, rotation of points in the det3d sense,
BEV corner generation, the intersection area of two convex quads by
Sutherland-Hodgman clipping, rotated BEV and 3D IoU, and the points-in-box
test of the GT database.
"""

from __future__ import annotations

import numpy as np


def limit_period(val, offset=0.5, period=np.pi * 2):
    return val - np.floor(val / period + offset) * period


def rotation_points_single_angle(points, angle, axis=2):
    """box_np_ops.rotation_points_single_angle (box_np_ops.py:182-204):
    `points @ rot_mat_T` — for a row vector this applies R(-angle), i.e. the
    det3d rotation sense. The whole repo uses the reference's det3d yaw
    convention (yaw_det3d = -yaw_devkit - pi/2, nusc_common.py:505), so
    every rotation helper here must keep this sense. points (N, 3)."""
    c, s = np.cos(angle), np.sin(angle)
    if axis == 2:
        rot_mat_T = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], points.dtype)
    elif axis == 1:
        rot_mat_T = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], points.dtype)
    else:
        rot_mat_T = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], points.dtype)
    return points @ rot_mat_T


def center_to_corner_box2d(centers, dims, angles):
    """(N, 2), (N, 2), (N,) -> (N, 4, 2) counter-clockwise BEV corners,
    rotated by R(-angle) as the reference's rotation_2d does."""
    corners = np.stack([
        np.stack([-dims[:, 0], -dims[:, 1]], -1),
        np.stack([dims[:, 0], -dims[:, 1]], -1),
        np.stack([dims[:, 0], dims[:, 1]], -1),
        np.stack([-dims[:, 0], dims[:, 1]], -1),
    ], axis=1) / 2.0
    c, s = np.cos(angles), np.sin(angles)
    rot = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], axis=1)
    return np.einsum("nij,nkj->nki", rot, corners) + centers[:, None, :]


def _polygon_clip(subject, clip_poly):
    """Sutherland-Hodgman; polygons (K, 2) counter-clockwise."""
    def inside(p, a, b):
        return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0]) >= -1e-12

    def intersect(p1, p2, a, b):
        d1 = p2 - p1
        d2 = b - a
        denom = d1[0] * d2[1] - d1[1] * d2[0]
        if abs(denom) < 1e-12:
            return p2
        t = ((a[0] - p1[0]) * d2[1] - (a[1] - p1[1]) * d2[0]) / denom
        return p1 + t * d1

    output = list(subject)
    for i in range(len(clip_poly)):
        a, b = clip_poly[i], clip_poly[(i + 1) % len(clip_poly)]
        if not output:
            return np.zeros((0, 2))
        inp = output
        output = []
        for j in range(len(inp)):
            cur, prev = inp[j], inp[j - 1]
            if inside(cur, a, b):
                if not inside(prev, a, b):
                    output.append(intersect(prev, cur, a, b))
                output.append(cur)
            elif inside(prev, a, b):
                output.append(intersect(prev, cur, a, b))
    return np.asarray(output)


def _polygon_area(poly):
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def rotated_box_overlap(corners_a, corners_b):
    """Intersection area of two convex quads (4, 2)."""
    return _polygon_area(_polygon_clip(corners_a, corners_b))


def boxes_bev_iou(boxes_a, boxes_b):
    """Rotated BEV IoU. boxes: (N, 5) [x y w l r] (pcdet layout: dims are
    full extents, r is yaw). Returns (N, M)."""
    ca = center_to_corner_box2d(boxes_a[:, :2], boxes_a[:, 2:4], boxes_a[:, 4])
    cb = center_to_corner_box2d(boxes_b[:, :2], boxes_b[:, 2:4], boxes_b[:, 4])
    area_a = boxes_a[:, 2] * boxes_a[:, 3]
    area_b = boxes_b[:, 2] * boxes_b[:, 3]
    out = np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    for i in range(len(boxes_a)):
        # cheap circumscribed-circle reject
        ra = 0.5 * np.hypot(boxes_a[i, 2], boxes_a[i, 3])
        rb = 0.5 * np.hypot(boxes_b[:, 2], boxes_b[:, 3])
        d = np.hypot(boxes_b[:, 0] - boxes_a[i, 0],
                     boxes_b[:, 1] - boxes_a[i, 1])
        cand = np.flatnonzero(d <= ra + rb)
        for j in cand:
            inter = rotated_box_overlap(ca[i], cb[j])
            union = area_a[i] + area_b[j] - inter
            if union > 0:
                out[i, j] = inter / union
    return out


def boxes_iou3d(boxes_a, boxes_b):
    """3D IoU of rotated boxes (N, 7) [x y z w l h r] with z the GRAVITY
    center (reference iou3d_nms_utils.boxes_iou3d_gpu semantics: BEV
    rotated intersection x z-extent overlap / volume union). Returns
    (N, M)."""
    bev_a = boxes_a[:, [0, 1, 3, 4, 6]]
    bev_b = boxes_b[:, [0, 1, 3, 4, 6]]
    ca = center_to_corner_box2d(bev_a[:, :2], bev_a[:, 2:4], bev_a[:, 4])
    cb = center_to_corner_box2d(bev_b[:, :2], bev_b[:, 2:4], bev_b[:, 4])
    za1 = boxes_a[:, 2] - boxes_a[:, 5] / 2
    za2 = boxes_a[:, 2] + boxes_a[:, 5] / 2
    zb1 = boxes_b[:, 2] - boxes_b[:, 5] / 2
    zb2 = boxes_b[:, 2] + boxes_b[:, 5] / 2
    vol_a = np.prod(boxes_a[:, 3:6], axis=1)
    vol_b = np.prod(boxes_b[:, 3:6], axis=1)
    out = np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    for i in range(len(boxes_a)):
        dz = (np.minimum(za2[i], zb2) - np.maximum(za1[i], zb1)).clip(0)
        cand = np.flatnonzero(dz > 0)
        for j in cand:
            inter_bev = rotated_box_overlap(ca[i], cb[j])
            inter = inter_bev * dz[j]
            union = vol_a[i] + vol_b[j] - inter
            if union > 0:
                out[i, j] = inter / union
    return out


def corner_overlap_bev(corners_a, corners_b, areas_a=None, areas_b=None):
    """Pairwise intersection areas for pre-computed corners."""
    out = np.zeros((len(corners_a), len(corners_b)), np.float32)
    for i in range(len(corners_a)):
        for j in range(len(corners_b)):
            out[i, j] = rotated_box_overlap(corners_a[i], corners_b[j])
    return out


def points_in_rbbox(points, boxes):
    """(N, 3+) points, (M, 7+) boxes [x y z w l h (...) r] -> (N, M) bool.
    Boxes are gravity-centered (nuScenes convention after info prep).

    Inverse of the det3d corner rotation: corners sit at c + R(-r)·template
    (see center_to_corner_box2d), so a point is inside iff R(+r)(p - c)
    falls within the half-extents."""
    n, m = len(points), len(boxes)
    out = np.zeros((n, m), bool)
    for j in range(m):
        x, y, z, w, l, h = boxes[j, :6]
        r = boxes[j, -1]
        p = points[:, :3] - np.array([x, y, z])
        c, s = np.cos(r), np.sin(r)
        px = p[:, 0] * c - p[:, 1] * s
        py = p[:, 0] * s + p[:, 1] * c
        out[:, j] = ((np.abs(px) <= w / 2) & (np.abs(py) <= l / 2)
                     & (np.abs(p[:, 2]) <= h / 2))
    return out
