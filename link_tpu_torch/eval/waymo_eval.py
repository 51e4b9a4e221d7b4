"""Waymo detection metrics, toolkit-free.

A copy of `link_tpu/eval/waymo_eval.py`, kept here so the port imports
nothing of the JAX package; the IoU comes from the port's `ops/box_np`.

The reference delegates AP to the waymo-open-dataset toolkit
(detection/det3d/datasets/waymo/waymo_common.py:52-115 writes
detection_pred.bin / gt_preds.bin and shells out to the official metric
binary). That toolkit isn't available here, so this module implements the
published Waymo detection metric directly:

  * matching: greedy by score on 3D IoU, per class, thresholds
    VEHICLE 0.7, PEDESTRIAN 0.5, CYCLIST 0.5;
  * AP: 101-point interpolated precision over recall (the official metric
    integrates p(r) with delta 0.05; the 101-point form converges to the
    same integral and matches our nuScenes evaluator's machinery);
  * difficulty: LEVEL_2 = gt with <= 5 lidar points (or annotator-marked,
    unavailable from the pickles alone); LEVEL_1 = the rest. LEVEL_2 AP
    is computed over ALL gts (official semantics: L2 includes L1).

Boxes are (N, 7+) [x y z w l h .. heading] in the det3d convention —
IoU is convention-consistent via ops/box_np.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ops.box_np import boxes_iou3d

WAYMO_CLASSES = ("VEHICLE", "PEDESTRIAN", "CYCLIST")
IOU_THRESH = {"VEHICLE": 0.7, "PEDESTRIAN": 0.5, "CYCLIST": 0.5}


def accumulate_class(gt_boxes: List[np.ndarray],
                     pred_boxes: List[np.ndarray],
                     pred_scores: List[np.ndarray], iou_th: float,
                     gt_keep: Optional[List[np.ndarray]] = None):
    """(AP, APH) for one class over samples. gt_keep masks gts for the
    difficulty bucket; ignored gts neither count as positives nor convert
    matched preds into false positives (official ignore semantics).

    APH is the official heading-weighted AP (waymo_common.py:52-115 gets
    it from the toolkit): each true positive's contribution to BOTH the
    precision numerator and the recall is scaled by the heading accuracy
    h = 1 - |Δheading| / π, with Δheading wrapped to [-π, π]."""
    if gt_keep is None:
        gt_keep = [np.ones(len(g), bool) for g in gt_boxes]
    npos = int(sum(k.sum() for k in gt_keep))
    if npos == 0:
        return float("nan"), float("nan")

    rows = []
    for si, (preds, scores) in enumerate(zip(pred_boxes, pred_scores)):
        for j in range(len(preds)):
            rows.append((float(scores[j]), si, j))
    rows.sort(key=lambda r: -r[0])

    ious = [boxes_iou3d(p[:, :7], g[:, :7]) if len(p) and len(g)
            else np.zeros((len(p), len(g)))
            for p, g in zip(pred_boxes, gt_boxes)]
    taken = [np.zeros(len(g), bool) for g in gt_boxes]
    tp, fp, hw = [], [], []
    for score, si, j in rows:
        iou_row = ious[si][j] if ious[si].shape[1] else np.zeros(0)
        cand = np.where(~taken[si], iou_row, -1.0)
        best = int(np.argmax(cand)) if len(cand) else -1
        if best >= 0 and cand[best] >= iou_th:
            taken[si][best] = True
            if gt_keep[si][best]:
                tp.append(1)
                fp.append(0)
                delta = (pred_boxes[si][j, 6] - gt_boxes[si][best, 6]) \
                    % (2 * np.pi)
                delta = min(delta, 2 * np.pi - delta)
                hw.append(max(0.0, 1.0 - delta / np.pi))
            # matched an ignored gt: drop from both counts
        else:
            tp.append(0)
            fp.append(1)
            hw.append(0.0)

    if not tp:
        return 0.0, 0.0
    tpc = np.cumsum(tp).astype(float)
    fpc = np.cumsum(fp).astype(float)
    hwc = np.cumsum(hw)
    rec_i = np.linspace(0, 1, 101)

    def integrate(num, rec):
        prec = num / np.maximum(tpc + fpc, 1e-9)
        prec_i = np.interp(rec_i, rec, prec, right=0)
        # monotone-decreasing envelope (official p(r): max over r' >= r)
        prec_i = np.maximum.accumulate(prec_i[::-1])[::-1]
        return float(np.mean(prec_i))

    ap = integrate(tpc, tpc / npos)
    aph = integrate(hwc, hwc / npos)
    return ap, aph


def evaluate_waymo(samples: List[Dict],
                   class_names: Sequence[str] = WAYMO_CLASSES) -> Dict:
    """samples: dicts with gt_boxes (N, 7+ det3d layout, heading last),
    gt_classes (1-based), pred_boxes, pred_scores, pred_labels (0-based),
    optional gt_num_pts. Returns per-class L1/L2 AP and APH + means."""
    out = {"ap_l1": {}, "ap_l2": {}, "aph_l1": {}, "aph_l2": {}}
    for ci, cls in enumerate(class_names):
        gts, preds, scores, keep_l1 = [], [], [], []
        for s in samples:
            classes = np.asarray(s["gt_classes"]).astype(int)
            gsel = classes == ci + 1
            g = np.asarray(s["gt_boxes"], float)[gsel]
            g7 = g[:, [0, 1, 2, 3, 4, 5, g.shape[1] - 1]] if len(g) else \
                np.zeros((0, 7))
            gts.append(g7)
            npts = s.get("gt_num_pts")
            keep_l1.append(np.asarray(npts)[gsel] > 5 if npts is not None
                           else np.ones(len(g7), bool))
            labels = np.asarray(s["pred_labels"]).astype(int)
            psel = labels == ci
            p = np.asarray(s["pred_boxes"], float)[psel]
            p7 = p[:, [0, 1, 2, 3, 4, 5, p.shape[1] - 1]] if len(p) else \
                np.zeros((0, 7))
            preds.append(p7)
            scores.append(np.asarray(s["pred_scores"], float)[psel])
        th = IOU_THRESH[cls]
        ap1, aph1 = accumulate_class(gts, preds, scores, th,
                                     gt_keep=keep_l1)
        ap2, aph2 = accumulate_class(gts, preds, scores, th)
        out["ap_l1"][cls], out["aph_l1"][cls] = ap1, aph1
        out["ap_l2"][cls], out["aph_l2"][cls] = ap2, aph2

    for k in ("ap_l1", "ap_l2", "aph_l1", "aph_l2"):
        vals = [v for v in out[k].values() if not np.isnan(v)]
        out["m" + k] = float(np.mean(vals)) if vals else 0.0
    return out


def write_waymo_submission(samples: List[Dict], out_path: str,
                           infos: Optional[Dict[str, Dict]] = None) -> str:
    """Official detection_pred.bin writer (waymo_common.py:52-115),
    toolkit-gated; falls back to a JSON with the same fields when
    waymo_open_dataset is unavailable. Predictions are converted back to
    the Waymo convention (heading = -det3d - pi/2, dims swapped to
    length/width — waymo_common.py:70-72)."""
    entries = []
    for s in samples:
        b = np.asarray(s["pred_boxes"], float).reshape(len(s["pred_scores"]),
                                                       -1)
        heading = -b[:, -1] - np.pi / 2
        for i in range(len(b)):
            entries.append({
                "token": s["token"],
                "center": [float(v) for v in b[i, :3]],
                "length": float(b[i, 4]), "width": float(b[i, 3]),
                "height": float(b[i, 5]), "heading": float(heading[i]),
                "score": float(s["pred_scores"][i]),
                "label": int(s["pred_labels"][i]),
            })
    try:
        from waymo_open_dataset import label_pb2
        from waymo_open_dataset.protos import metrics_pb2
    except ImportError:
        import json
        with open(out_path + ".json", "w") as f:
            json.dump(entries, f)
        return out_path + ".json"

    label_to_type = {0: 1, 1: 2, 2: 4}     # ignore SIGN (waymo_common.py:39)
    objects = metrics_pb2.Objects()
    for e in entries:
        o = metrics_pb2.Object()
        info = (infos or {}).get(e["token"], {})
        o.context_name = info.get("scene_name", e["token"])
        o.frame_timestamp_micros = int(info.get("timestamp_micros", 0))
        box = label_pb2.Label.Box()
        box.center_x, box.center_y, box.center_z = e["center"]
        box.length, box.width, box.height = (e["length"], e["width"],
                                             e["height"])
        box.heading = e["heading"]
        o.object.box.CopyFrom(box)
        o.score = e["score"]
        o.object.type = label_to_type[e["label"]]
        objects.objects.append(o)
    with open(out_path, "wb") as f:
        f.write(objects.SerializeToString())
    return out_path
