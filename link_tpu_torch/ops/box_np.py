"""NumPy box math for the host-side NMS.

A copy of the part of `link_tpu/ops/box_np.py` that rotated NMS needs:
BEV corner generation in the det3d rotation sense and the intersection
area of two convex quads by Sutherland-Hodgman clipping.
"""

from __future__ import annotations

import numpy as np


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
