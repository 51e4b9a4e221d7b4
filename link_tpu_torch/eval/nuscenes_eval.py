"""nuScenes detection metrics (mAP / TP errors / NDS), devkit-free.

A copy of `link_tpu/eval/nuscenes_eval.py`, kept here so that the port
imports nothing of the JAX package.

The reference calls the official nuscenes-devkit NuScenesEval
(detection/det3d/datasets/nuscenes/nuscenes.py:208-347, nusc_common.py:610).
The port does not depend on that devkit, so this module implements
the devkit's `detection_cvpr_2019` configuration faithfully:

  * per-class range filtering (devkit class_range) of BOTH gt and preds by
    BEV distance from the ego position, plus the num_lidar_pts==0 gt drop;
  * per-class AP: greedy center-distance matching at {0.5, 1, 2, 4} m,
    101-point interpolated precision with the 10%/10% recall/precision
    clamps;
  * TP errors at the 2 m threshold, cum-meaned over matches and
    interpolated onto the 101-point grid BY CONFIDENCE (devkit
    detection/algo.py accumulate): ATE (center L2), ASE (1 - aligned 3D
    IoU), AOE (yaw delta; period pi for barrier, ignored for
    traffic_cone), AVE (velocity L2; ignored for barrier/cone), AAE
    (attribute mismatch, pred attribute from the velocity heuristic of
    eval/submission.py:33; ignored for barrier/cone; matches whose gt
    attribute is empty contribute NaN to the cummean, and an all-NaN
    series scores worst-case 1.0 exactly like the devkit's cummean);
  * NDS = (5 * mAP + sum(1 - min(1, err))) / 10.

Boxes carry the det3d yaw convention internally; yaw differences are
convention-invariant up to sign, which the period fold absorbs. When
`infos` are provided to group_by_class, boxes are converted to the global
frame and filtered around the true ego position (nusc_common.py:181-214);
otherwise the lidar origin approximates the ego position (they coincide to
within the sensor mount offset).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

DIST_THS = (0.5, 1.0, 2.0, 4.0)
TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")

CLASS_NAMES = ("car", "truck", "construction_vehicle", "bus", "trailer",
               "barrier", "motorcycle", "bicycle", "pedestrian",
               "traffic_cone")

# devkit configs/detection_cvpr_2019.json
CLASS_RANGE = {
    "car": 50, "truck": 50, "bus": 50, "trailer": 50,
    "construction_vehicle": 50, "pedestrian": 40, "motorcycle": 40,
    "bicycle": 40, "traffic_cone": 30, "barrier": 30,
}
# devkit TP-metric exclusions (LEAVES of detection/data_classes.py)
NO_VEL = ("barrier", "traffic_cone")      # no mAVE / mAAE
NO_ORIENT = ("traffic_cone",)             # no mAOE
PERIOD_PI = ("barrier",)                  # AOE folded to pi


def _attr_for(name: str, velocity) -> str:
    """Prediction-side attribute heuristic (reference nuscenes.py:260-292,
    shared with eval/submission.py)."""
    from .submission import _attr_for as f
    return f(name, np.asarray(velocity))


def _aligned_3d_iou(gt_box, pred_box):
    """IoU of aligned (centered, axis-aligned) boxes — devkit scale_iou."""
    inter = np.prod(np.minimum(gt_box[3:6], pred_box[3:6]))
    union = np.prod(gt_box[3:6]) + np.prod(pred_box[3:6]) - inter
    return inter / max(union, 1e-9)


def _yaw_diff(a, b, period=2 * np.pi):
    d = (a - b) % period
    return min(d, period - d)


def _cummean(x: np.ndarray) -> np.ndarray:
    """Cumulative mean ignoring NaNs (devkit utils.cummean)."""
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    count = np.cumsum(~np.isnan(x))
    return np.nancumsum(x) / np.maximum(count, 1).astype(float)


def filter_eval_boxes(boxes: np.ndarray, names: Sequence[str],
                      center_xy=(0.0, 0.0),
                      num_pts: Optional[np.ndarray] = None) -> np.ndarray:
    """Devkit loaders.filter_eval_boxes: keep boxes within their class's
    range of the ego position; drop gt with zero lidar points when counts
    are available. Returns a bool keep-mask."""
    keep = np.ones(len(boxes), bool)
    for i, name in enumerate(names):
        rng = CLASS_RANGE.get(name, 50)
        d = np.hypot(boxes[i, 0] - center_xy[0], boxes[i, 1] - center_xy[1])
        keep[i] = d <= rng
    if num_pts is not None:
        keep &= np.asarray(num_pts) > 0
    return keep


def accumulate(gt_boxes: List[np.ndarray], pred_boxes: List[np.ndarray],
               pred_scores: List[np.ndarray], dist_th: float,
               cls: str = "car",
               gt_attrs: Optional[List[Sequence[str]]] = None):
    """Single-class accumulation over samples (devkit detection/algo.py
    accumulate). Boxes (N, 9): [x y z w l h vx vy yaw]. Returns dict with
    interpolated precision/confidence and TP-error curves."""
    npos = sum(len(g) for g in gt_boxes)
    if npos == 0:
        return None
    all_rows = []
    for si, (preds, scores) in enumerate(zip(pred_boxes, pred_scores)):
        for j in range(len(preds)):
            all_rows.append((float(scores[j]), si, j))
    all_rows.sort(key=lambda r: -r[0])

    period = np.pi if cls in PERIOD_PI else 2 * np.pi
    taken = [set() for _ in gt_boxes]
    tp, fp, conf = [], [], []
    errs = {m: [] for m in TP_METRICS}
    for score, si, j in all_rows:
        pb = pred_boxes[si][j]
        gts = gt_boxes[si]
        best, best_d = -1, float("inf")
        for gi in range(len(gts)):
            if gi in taken[si]:
                continue
            d = np.hypot(pb[0] - gts[gi][0], pb[1] - gts[gi][1])
            if d < best_d:
                best, best_d = gi, d
        if best >= 0 and best_d < dist_th:
            taken[si].add(best)
            tp.append(1)
            fp.append(0)
            g = gts[best]
            errs["trans_err"].append(best_d)
            errs["scale_err"].append(1 - _aligned_3d_iou(g, pb))
            errs["orient_err"].append(
                np.nan if cls in NO_ORIENT else _yaw_diff(g[8], pb[8],
                                                          period))
            errs["vel_err"].append(
                np.nan if cls in NO_VEL
                else np.hypot(g[6] - pb[6], g[7] - pb[7]))
            if cls in NO_VEL:
                errs["attr_err"].append(np.nan)
            else:
                gt_attr = ""
                if gt_attrs is not None and len(gt_attrs[si]) > best:
                    gt_attr = gt_attrs[si][best]
                if not gt_attr:
                    errs["attr_err"].append(np.nan)
                else:
                    pred_attr = _attr_for(cls, pb[6:8])
                    errs["attr_err"].append(float(pred_attr != gt_attr))
            conf.append(score)
        else:
            tp.append(0)
            fp.append(1)

    ntp = int(np.sum(tp))
    if ntp == 0:
        return None
    tpc = np.cumsum(tp).astype(float)
    fpc = np.cumsum(fp).astype(float)
    prec = tpc / (tpc + fpc)
    rec = tpc / npos
    all_conf = np.array([r[0] for r in all_rows])

    rec_interp = np.linspace(0, 1, 101)
    prec_i = np.interp(rec_interp, rec, prec, right=0)
    conf_i = np.interp(rec_interp, rec, all_conf, right=0)
    out = {"precision": prec_i, "confidence": conf_i}
    # devkit: cummean the per-match errors, then resample onto the
    # 101-grid BY CONFIDENCE (algo.py:119-124)
    match_conf = np.asarray(conf)
    for m in TP_METRICS:
        tmp = _cummean(np.asarray(errs[m], float))
        out[m] = np.interp(conf_i[::-1], match_conf[::-1], tmp[::-1])[::-1]
    return out


def calc_ap(md, min_recall=0.1, min_precision=0.1) -> float:
    prec = md["precision"].copy()
    prec = prec[int(min_recall * 100) + 1:]
    prec -= min_precision
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - min_precision)


def calc_tp(md, metric: str, min_recall=0.1) -> float:
    """Mean TP error over recall in (min_recall, max achieved recall]
    (devkit algo.py calc_tp)."""
    conf = md["confidence"]
    nonzero = np.nonzero(conf)[0]
    max_recall_ind = nonzero[-1] if len(nonzero) else 0
    first = int(min_recall * 100) + 1
    if max_recall_ind < first:
        return 1.0
    return float(np.mean(md[metric][first:max_recall_ind + 1]))


def evaluate_nuscenes(gt_by_class: Dict[str, List[np.ndarray]],
                      pred_by_class: Dict[str, List[np.ndarray]],
                      score_by_class: Dict[str, List[np.ndarray]],
                      class_names: Sequence[str] = CLASS_NAMES,
                      attrs_by_class: Optional[Dict[str, List]] = None
                      ) -> Dict:
    """Compute per-class AP / TP errors + mAP + NDS."""
    aps = {}
    tps = {}
    for cls in class_names:
        gt_attrs = attrs_by_class.get(cls) if attrs_by_class else None
        mds = {}
        for th in DIST_THS:
            mds[th] = accumulate(gt_by_class.get(cls, []),
                                 pred_by_class.get(cls, []),
                                 score_by_class.get(cls, []), th,
                                 cls=cls, gt_attrs=gt_attrs)
        aps[cls] = np.mean([calc_ap(mds[th]) if mds[th] else 0.0
                            for th in DIST_THS])
        md2 = mds[2.0]
        errs = {}
        for m in TP_METRICS:
            if (cls in NO_VEL and m in ("vel_err", "attr_err")) or \
                    (cls in NO_ORIENT and m == "orient_err"):
                errs[m] = np.nan
            elif md2 is None:
                errs[m] = 1.0
            else:
                errs[m] = calc_tp(md2, m)
        tps[cls] = errs

    mean_ap = float(np.mean([aps[c] for c in class_names]))
    mean_tps = {}
    for m in TP_METRICS:
        vals = [tps[c][m] for c in class_names
                if not np.isnan(tps[c][m])]
        mean_tps[m] = float(np.mean(vals)) if vals else 1.0
    nds = (5 * mean_ap + sum(max(0.0, 1.0 - min(1.0, mean_tps[m]))
                             for m in TP_METRICS)) / 10.0
    return {"mean_ap": mean_ap, "nds": float(nds), "class_aps": aps,
            "tp_errors": mean_tps, "class_tps": tps}


def group_by_class(samples: List[Dict], class_names=CLASS_NAMES,
                   infos: Optional[Dict[str, Dict]] = None):
    """samples: per-sample dicts with gt_boxes (N, 9), gt_classes (1-based),
    pred_boxes, pred_scores, pred_labels (0-based global), optional
    gt_attributes (N,) and gt_num_pts (N,). Applies the devkit class-range
    filter to both sides. When `infos` (token -> info) is given, boxes are
    converted to the global frame and the range filter centers on the true
    ego position (nusc_common.py:181-214); otherwise the lidar origin
    stands in. Returns (gt, pred, score, attrs) dicts — the first three
    positional for backward compatibility."""
    from .submission import boxes_lidar_to_global, det3d_to_devkit_yaw

    gt_c = {c: [] for c in class_names}
    pr_c = {c: [] for c in class_names}
    sc_c = {c: [] for c in class_names}
    at_c = {c: [] for c in class_names}
    for s in samples:
        gt = np.asarray(s["gt_boxes"], float).reshape(-1, 9)
        pred = np.asarray(s["pred_boxes"], float).reshape(-1, 9)
        scores = np.asarray(s["pred_scores"], float)
        labels = np.asarray(s["pred_labels"]).astype(int)
        classes = np.asarray(s["gt_classes"]).astype(int)
        attrs = np.asarray(s.get("gt_attributes",
                                 [""] * len(gt)), object)
        num_pts = s.get("gt_num_pts")

        center = (0.0, 0.0)
        info = infos.get(s["token"]) if infos else None
        if info is not None:
            gt = boxes_lidar_to_global(det3d_to_devkit_yaw(gt), info)
            pred = boxes_lidar_to_global(det3d_to_devkit_yaw(pred), info)
            ego = np.linalg.inv(info["car_from_global"])[:2, 3]
            center = (float(ego[0]), float(ego[1]))

        gt_names = [class_names[c - 1] if 1 <= c <= len(class_names)
                    else "" for c in classes]
        pred_names = [class_names[l] if 0 <= l < len(class_names) else ""
                      for l in labels]
        gkeep = filter_eval_boxes(gt, gt_names, center, num_pts)
        pkeep = filter_eval_boxes(pred, pred_names, center)

        for ci, cls in enumerate(class_names):
            gsel = (classes == ci + 1) & gkeep
            gt_c[cls].append(gt[gsel])
            at_c[cls].append([a for a, k in zip(attrs, gsel) if k])
            psel = (labels == ci) & pkeep
            pr_c[cls].append(pred[psel])
            sc_c[cls].append(scores[psel])
    return gt_c, pr_c, sc_c, at_c
