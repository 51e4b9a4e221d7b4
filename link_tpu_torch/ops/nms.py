"""NMS: host rotated NMS (native or NumPy), circle NMS, and the on-device
rotated and circle NMS over fixed-size candidate sets.

Port of `link_tpu/ops/nms.py` (reference core/bbox/box_torch_ops.py:248-276
over iou3d_nms, and core/utils/circle_nms_jit.py:5-28):

  * `rotate_nms_pcdet`: score-sorted greedy suppression by BEV rotated IoU
    on the host, through the native library (`link_tpu_torch/native`,
    Sutherland-Hodgman clipping in double precision) or, when the caller
    asks for it, the NumPy copy;
  * `circle_nms`: centre-distance NMS on the host;
  * `rotated_iou_bev`, `rotate_nms_device`, `circle_nms_device`: the
    PyTorch twins of `rotated_iou_bev_jax`, `rotate_nms_jax` and
    `circle_nms_jax`, which keep the candidates on the device and return a
    keep mask in input order. `rotate_nms_device` is the plain twin of the
    hand-written kernel `ops.kernels.rotated_nms`, which the det serving
    path calls.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from .box_np import center_to_corner_box2d, rotated_box_overlap

def rotate_nms_pcdet(boxes: np.ndarray, scores: np.ndarray,
                     thresh: float, pre_maxsize: int = None,
                     post_max_size: int = None,
                     impl: str = "native") -> np.ndarray:
    """boxes (N, 7) [x y z w l h r] (pcdet convention; the overlap is the
    BEV rotated IoU). Returns kept indices into the input order,
    score-descending. impl "native" runs the C++ kernel, "numpy" the NumPy
    copy of the same suppression."""
    native.check_impl(impl)
    order = np.argsort(-scores, kind="stable")
    if pre_maxsize is not None:
        order = order[:pre_maxsize]
    n = len(order)
    if n == 0:
        return np.zeros((0,), np.int64)
    if impl == "native":
        kept = native.rotate_nms_sorted(boxes[order], float(thresh),
                                        post_max_size or 0)
        return order[kept]

    b = boxes[order]
    corners = center_to_corner_box2d(b[:, :2], b[:, 3:5], b[:, 6])
    areas = b[:, 3] * b[:, 4]
    rad = 0.5 * np.hypot(b[:, 3], b[:, 4])
    suppressed = np.zeros(n, bool)
    keep = []
    for i in range(n):
        if suppressed[i]:
            continue
        keep.append(i)
        if post_max_size is not None and len(keep) >= post_max_size:
            break
        # circumscribed-circle reject before the polygon clip
        d = np.hypot(b[i + 1:, 0] - b[i, 0], b[i + 1:, 1] - b[i, 1])
        cand = np.flatnonzero((d <= rad[i] + rad[i + 1:])
                              & ~suppressed[i + 1:]) + i + 1
        for j in cand:
            inter = rotated_box_overlap(corners[i], corners[j])
            union = areas[i] + areas[j] - inter
            if union > 0 and inter / union > thresh:
                suppressed[j] = True
    return order[np.asarray(keep, np.int64)]


def circle_nms(boxes: np.ndarray, thresh: float,
               post_max_size: int = 83) -> np.ndarray:
    """Centre-distance NMS (circle_nms_jit.py:5-28). boxes (N, 3):
    [x, y, score], assumed score-sorted descending."""
    n = len(boxes)
    suppressed = np.zeros(n, bool)
    keep = []
    for i in range(n):
        if suppressed[i]:
            continue
        keep.append(i)
        dx = boxes[i + 1:, 0] - boxes[i, 0]
        dy = boxes[i + 1:, 1] - boxes[i, 1]
        suppressed[i + 1:] |= (dx * dx + dy * dy) < thresh
    return np.asarray(keep[:post_max_size], np.int64)


def _corners_local(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 5) [x y w l r] -> (N, 4, 2) counter-clockwise corners about the
    box's centre, rotated by R(-r) (box_np.center_to_corner_box2d less the
    centre)."""
    angles = boxes[:, 4]
    # the half-extents by sign, with no constant copied from the host, so
    # that the twin can be captured in a CUDA graph
    w, l = boxes[:, 2] * 0.5, boxes[:, 3] * 0.5
    corners = torch.stack([torch.stack([-w, -l], -1),
                           torch.stack([w, -l], -1),
                           torch.stack([w, l], -1),
                           torch.stack([-w, l], -1)], dim=1)
    c, s = torch.cos(angles), torch.sin(angles)
    rot = torch.stack([torch.stack([c, s], -1),
                       torch.stack([-s, c], -1)], dim=1)
    return torch.einsum("nij,nkj->nki", rot, corners)


def _cross(o, a, b):
    return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
            - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))


def rotated_iou_bev(boxes: torch.Tensor) -> torch.Tensor:
    """All-pairs rotated BEV IoU (N, N) of (N, 5) [x y w l r] boxes.

    The formulation of `rotated_iou_bev_jax`: the intersection of two convex
    quads is the convex hull of at most 24 candidate vertices (corners of A
    inside B, corners of B inside A, and the 16 edge-pair crossings); the
    valid candidates are ordered by angle around their centroid (stable
    sort, invalid ones last) and the area is a masked shoelace.

    Each pair (i, j) is computed about box i's centre. `rotated_iou_bev_jax`
    works in absolute coordinates, where the shoelace's float32 products of
    coordinates near 54 m (the edge of the nuScenes range) lose up to ~3e-4
    of IoU against the double-precision clip of `native` and of the kernel;
    about box i's centre every value is of the boxes' own size."""
    n = boxes.shape[0]
    loc = _corners_local(boxes)                              # (N, 4, 2)
    # pair (i, j): A = box i's corners, B = box j's, both about i's centre
    qa = loc[:, None].expand(n, n, 4, 2)
    qb = loc[None, :] + (boxes[None, :, None, :2]
                         - boxes[:, None, None, :2])         # (N,N,4,2)
    qa_next = torch.roll(qa, -1, dims=2)
    qb_next = torch.roll(qb, -1, dims=2)
    area = boxes[:, 2] * boxes[:, 3]

    in_ab = (_cross(qb[:, :, None], qb_next[:, :, None], qa[:, :, :, None])
             >= -1e-6).all(-1)                               # (N,N,4)
    in_ba = (_cross(qa[:, :, None], qa_next[:, :, None], qb[:, :, :, None])
             >= -1e-6).all(-1)                               # (N,N,4)

    a0 = qa[:, :, :, None, :]
    a1 = qa_next[:, :, :, None, :]
    b0 = qb[:, :, None, :, :]
    b1 = qb_next[:, :, None, :, :]
    d1 = a1 - a0
    d2 = b1 - b0
    denom = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    db = b0 - a0
    flat = denom.abs() < 1e-9
    safe = torch.where(flat, torch.ones_like(denom), denom)
    t = (db[..., 0] * d2[..., 1] - db[..., 1] * d2[..., 0]) / safe
    u = (db[..., 0] * d1[..., 1] - db[..., 1] * d1[..., 0]) / safe
    ok = ~flat & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)   # (N,N,4,4)
    px = a0 + t[..., None] * d1                              # (N,N,4,4,2)

    pts = torch.cat([qa, qb, px.reshape(n, n, 16, 2)], dim=2)  # (N,N,24,2)
    msk = torch.cat([in_ab, in_ba, ok.reshape(n, n, 16)], dim=2)

    k = msk.sum(-1)                                          # (N,N)
    cnt = k.clamp(min=1).to(boxes.dtype)
    ctr = (torch.where(msk[..., None], pts, torch.zeros_like(pts)).sum(2)
           / cnt[..., None])                                 # (N,N,2)
    ang = torch.atan2(pts[..., 1] - ctr[..., None, 1],
                      pts[..., 0] - ctr[..., None, 0])
    ang = torch.where(msk, ang, torch.full_like(ang, float("inf")))
    order = torch.sort(ang, dim=-1, stable=True).indices
    sp = torch.gather(pts, 2, order[..., None].expand(n, n, 24, 2))
    idx = torch.arange(24, device=boxes.device)
    # the next vertex of each valid one, wrapping at the k-th (the index
    # past the last candidate is taken mod 24: its term is masked below)
    nxt = torch.where(idx[None, None, :] == k[..., None] - 1,
                      torch.zeros_like(idx), (idx + 1) % 24)
    sn = torch.gather(sp, 2, nxt[..., None].expand(n, n, 24, 2))
    contrib = sp[..., 0] * sn[..., 1] - sn[..., 0] * sp[..., 1]
    contrib = torch.where(idx[None, None, :] < k[..., None], contrib,
                          torch.zeros_like(contrib))
    inter = 0.5 * contrib.sum(-1).abs()
    inter = torch.where(k >= 3, inter, torch.zeros_like(inter))
    union = area[:, None] + area[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def nms_keep(over: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             max_keep: int) -> torch.Tensor:
    """Greedy suppression over an input-order overlap matrix over (N, N)
    bool: in descending masked score (ties by the lower index: JAX's stable
    `argsort(-where(valid, scores, -inf))`), a valid candidate that no kept
    one overlaps is kept, and it suppresses the later candidates it
    overlaps; the first max_keep kept stay. Returns the keep mask (N,) in
    input order. With a leading set dimension (over (S, N, N), scores and
    valid (S, N)) each set gives what its own call gives, in one walk over
    the N ranks for all sets."""
    if scores.dim() == 1:
        return nms_keep(over[None], scores[None], valid[None], max_keep)[0]
    sets, n = scores.shape
    key = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    order = torch.sort(-key, dim=1, stable=True).indices      # (S, N)
    valid_s = torch.gather(valid, 1, order)
    rows = torch.gather(over, 1, order[:, :, None].expand(sets, n, n))
    over_s = (torch.gather(rows, 2, order[:, None, :].expand(sets, n, n))
              & valid_s[:, None, :] & valid_s[:, :, None])
    later = torch.arange(n, device=scores.device)
    supp = ~valid_s
    for i in range(n):
        supp = supp | (over_s[:, i] & (later > i) & ~supp[:, i:i + 1])
    keep_s = ~supp & valid_s
    keep_s = keep_s & (torch.cumsum(keep_s.to(torch.int32), 1) <= max_keep)
    return torch.zeros_like(valid).scatter(1, order, keep_s)


def rotate_nms_device(boxes: torch.Tensor, scores: torch.Tensor,
                      valid: torch.Tensor, thresh: float,
                      max_keep: int) -> torch.Tensor:
    """Rotated NMS over a fixed-size candidate set, the twin of
    `rotate_nms_jax`: boxes (N, 5) [x y w l r], scores (N,), valid (N,)
    bool. Returns the keep mask in input order: at most max_keep kept, with
    priority by descending score (ties by the lower index); a pair
    overlaps when its `rotated_iou_bev` exceeds thresh. With a leading set
    dimension (boxes (S, N, 5), scores and valid (S, N)) each set gives
    what its own call gives (the IoU one set at a time, the walk once)."""
    if scores.dim() == 1:
        return nms_keep(rotated_iou_bev(boxes) > thresh, scores, valid,
                        max_keep)
    over = torch.stack([rotated_iou_bev(b) > thresh for b in boxes])
    return nms_keep(over, scores, valid, max_keep)


def circle_nms_device(xy: torch.Tensor, scores: torch.Tensor,
                      valid: torch.Tensor, min_radius: float,
                      max_keep: int) -> torch.Tensor:
    """Circle NMS over a fixed-size candidate set, the twin of
    `circle_nms_jax`: a pair overlaps when its squared centre distance is
    below min_radius. Returns the keep mask in input order."""
    d2 = ((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1)
    return nms_keep(d2 < min_radius, scores, valid, max_keep)
