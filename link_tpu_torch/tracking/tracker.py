"""CenterPoint-style velocity tracker (host-side NumPy).

A copy of `link_tpu/tracking/tracker.py`, kept here so the port imports
nothing of the JAX package.

Re-implementation of the reference's tracking-by-detection scheme
(detection/tools/nusc_tracking/pub_tracker.py:34-154,
waymo_tracking/tracker.py) as one configurable tracker:

  * each detection is back-projected by its predicted velocity
    (ct - v * time_lag) to the previous frame;
  * per-class gating distance (99.9-percentile velocity-error radii for
    nuScenes; caller-supplied for Waymo) + class-consistency mask;
  * greedy nearest-neighbour assignment (or Hungarian via scipy);
  * unmatched detections open new tracks; unmatched tracks coast up to
    `max_age` frames, advanced by their last velocity, and are not
    emitted as active.

Tracking is inherently sequential over frames and tiny (tens of boxes)
— host NumPy is the right tool; the card's job ends at detection.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

NUSC_TRACKING_NAMES = ("bicycle", "bus", "car", "motorcycle", "pedestrian",
                       "trailer", "truck")

# 99.9-percentile l2 velocity-error radii per class (m / 0.5 s), from the
# reference (pub_tracker.py:22-30) — gating hyperparameters, must match.
NUSC_CLS_VELOCITY_ERROR = {
    "car": 4.0, "truck": 4.0, "bus": 5.5, "trailer": 3.0,
    "pedestrian": 1.0, "motorcycle": 13.0, "bicycle": 3.0,
}

WAYMO_TRACKING_NAMES = ("VEHICLE", "PEDESTRIAN", "CYCLIST")


def greedy_assignment(dist: np.ndarray) -> np.ndarray:
    """Row-greedy min-cost assignment (track_utils.py:4-12 semantics):
    detections claim their nearest surviving track in order; claimed
    columns are retired. Returns (P, 2) [det_idx, track_idx]."""
    n, m = dist.shape
    if m == 0:
        return np.zeros((0, 2), np.int32)
    dist = dist.copy()
    out = []
    for i in range(n):
        j = int(dist[i].argmin())
        if dist[i, j] < 1e16:
            dist[:, j] = 1e18
            out.append((i, j))
    return np.asarray(out, np.int32).reshape(-1, 2)


def hungarian_assignment(dist: np.ndarray) -> np.ndarray:
    from scipy.optimize import linear_sum_assignment
    rows, cols = linear_sum_assignment(np.minimum(dist, 1e18))
    return np.stack([rows, cols], axis=1).astype(np.int32)


class CenterTracker:
    """Greedy closest-point tracker over per-frame detection dicts.

    Each detection dict needs: translation (>=2), velocity (>=2),
    detection_name, detection_score. `step(results, time_lag)` returns
    the updated track list; entries carry tracking_id / age / active.
    """

    def __init__(self, tracking_names=NUSC_TRACKING_NAMES,
                 cls_velocity_error: Optional[Dict[str, float]] = None,
                 max_age: int = 3, hungarian: bool = False,
                 score_thresh: float = 0.0):
        self.names = tuple(tracking_names)
        self.gate = dict(cls_velocity_error or NUSC_CLS_VELOCITY_ERROR)
        self.max_age = max_age
        self.hungarian = hungarian
        self.score_thresh = score_thresh
        self.reset()

    def reset(self):
        self.id_count = 0
        self.tracks: List[Dict] = []

    def step(self, results: List[Dict], time_lag: float) -> List[Dict]:
        dets = []
        for det in results:
            if det["detection_name"] not in self.names:
                continue
            if det.get("detection_score", 1.0) < self.score_thresh:
                continue
            det = dict(det)
            det["ct"] = np.asarray(det["translation"][:2], np.float32)
            # back-project to the previous frame by the predicted motion
            det["tracking"] = (-time_lag
                               * np.asarray(det["velocity"][:2], np.float32))
            det["label_preds"] = self.names.index(det["detection_name"])
            dets.append(det)
        if not dets:
            self.tracks = []
            return []

        n, m = len(dets), len(self.tracks)
        pts = np.stack([d["ct"] + d["tracking"] for d in dets])      # (N, 2)
        det_cat = np.asarray([d["label_preds"] for d in dets])
        gate = np.asarray([self.gate.get(d["detection_name"], np.inf)
                           for d in dets], np.float32)

        if m > 0:
            trk = np.stack([t["ct"] for t in self.tracks])           # (M, 2)
            trk_cat = np.asarray([t["label_preds"] for t in self.tracks])
            dist = np.sqrt(((pts[:, None] - trk[None]) ** 2).sum(-1))
            invalid = (dist > gate[:, None]) | (det_cat[:, None]
                                                != trk_cat[None])
            dist = np.where(invalid, 1e18, dist)
            assign = (hungarian_assignment if self.hungarian
                      else greedy_assignment)
            matched = assign(dist)
            if self.hungarian:   # drop gated pairs the solver still paired
                matched = matched[dist[matched[:, 0], matched[:, 1]] < 1e16]
        else:
            matched = np.zeros((0, 2), np.int32)

        matched_d = set(int(i) for i in matched[:, 0])
        matched_t = set(int(j) for j in matched[:, 1])
        ret = []
        for di, ti in matched:
            t = dets[di]
            t["tracking_id"] = self.tracks[ti]["tracking_id"]
            t["age"] = 1
            t["active"] = self.tracks[ti]["active"] + 1
            ret.append(t)
        for di, d in enumerate(dets):
            if di in matched_d:
                continue
            self.id_count += 1
            d["tracking_id"] = self.id_count
            d["age"] = 1
            d["active"] = 1
            ret.append(d)
        # coast unmatched tracks, advanced by their last motion
        for ti, t in enumerate(self.tracks):
            if ti in matched_t:
                continue
            if t["age"] < self.max_age:
                t["age"] += 1
                t["active"] = 0
                t["ct"] = t["ct"] - t["tracking"]     # move forward
                ret.append(t)
        self.tracks = ret
        return ret
