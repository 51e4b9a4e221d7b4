"""Waymo tracking from detection results, in the PyTorch port.

A copy of tools/waymo_track.py: the equivalent of the reference's Waymo
tracking driver (detection/tools/waymo_tracking/test.py:72-160): lift per-frame
detections into the global frame via each frame's veh_to_global pose,
run the CenterPoint velocity tracker per sequence, and write per-token
tracking results (box3d_lidar / label_preds / scores / tracking_ids)
ready for the official compute_tracking_metrics_main (toolkit-gated,
like the rest of the Waymo pipeline).

Inputs: detections pkl {token: {box3d_lidar (N, 9), label_preds (N,),
scores (N,)}} in the det3d box convention, infos pkl from
tools/create_data_waymo (token, timestamp, veh_to_global).

Usage:
  python3 -m link_tpu_torch.tools.waymo_track --detections dets.pkl \
      --info infos_val_01sweeps.pkl --work-dir runs/track
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

LABEL_TO_NAME = {0: "VEHICLE", 1: "PEDESTRIAN", 2: "CYCLIST"}


def transform_box(box: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """Transform det3d boxes (N, 9) [x y z w l h vx vy heading] by a 4x4
    pose (waymo_tracking/test.py:162-186 semantics)."""
    out = box.copy()
    heading = box[:, -1] + np.arctan2(pose[1, 0], pose[0, 0])
    center = box[:, :3] @ pose[:3, :3].T + pose[:3, 3]
    vel = np.concatenate([box[:, 6:8], np.zeros((len(box), 1))], axis=1)
    vel = vel @ pose[:3, :3].T
    out[:, :3] = center
    out[:, 6:8] = vel[:, :2]
    out[:, -1] = heading
    return out


def to_global_dets(det: dict, pose: np.ndarray):
    boxes = transform_box(np.asarray(det["box3d_lidar"], np.float64), pose)
    labels = np.asarray(det["label_preds"])
    scores = np.asarray(det["scores"])
    out = []
    for i in range(len(boxes)):
        out.append({
            "translation": boxes[i, :3],
            "velocity": boxes[i, 6:8],
            "detection_name": LABEL_TO_NAME.get(int(labels[i]), "?"),
            "detection_score": float(scores[i]),
            "box_id": i,
        })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--detections", required=True, help="detections pkl")
    ap.add_argument("--info", required=True, help="waymo infos pkl")
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--max-age", type=int, default=3)
    ap.add_argument("--vehicle", type=float, default=0.8)
    ap.add_argument("--pedestrian", type=float, default=0.4)
    ap.add_argument("--cyclist", type=float, default=0.6)
    ap.add_argument("--score-thresh", type=float, default=0.75)
    args = ap.parse_args(argv)

    from ..tracking import CenterTracker, WAYMO_TRACKING_NAMES
    max_dist = {"VEHICLE": args.vehicle, "PEDESTRIAN": args.pedestrian,
                "CYCLIST": args.cyclist}
    tracker = CenterTracker(tracking_names=WAYMO_TRACKING_NAMES,
                            cls_velocity_error=max_dist,
                            max_age=args.max_age,
                            score_thresh=args.score_thresh)

    with open(args.detections, "rb") as f:
        detections = pickle.load(f)
    with open(args.info, "rb") as f:
        infos = {i["token"]: i for i in pickle.load(f)}

    # order frames by (sequence, frame index): token format seq_X_frame_Y
    def order_key(tok):
        info = infos[tok]
        return (info.get("seq_id", tok.rsplit("_frame_", 1)[0]),
                float(info["timestamp"]))

    tokens = sorted((t for t in detections if t in infos), key=order_key)
    results = {}
    last_seq, last_ts = None, 0.0
    for tok in tokens:
        info = infos[tok]
        seq = info.get("seq_id", tok.rsplit("_frame_", 1)[0])
        ts = float(info["timestamp"])
        ts = ts * 1e-6 if ts > 1e12 else ts
        if seq != last_seq:
            tracker.reset()
            last_ts = ts
            last_seq = seq
        time_lag = ts - last_ts
        last_ts = ts

        pose = np.reshape(np.asarray(info["veh_to_global"], np.float64),
                          (4, 4))
        dets = to_global_dets(detections[tok], pose)
        outputs = tracker.step(dets, time_lag)
        keep = [o["box_id"] for o in outputs if o["active"] > 0]
        ids = [o["tracking_id"] for o in outputs if o["active"] > 0]
        det = detections[tok]
        results[tok] = {
            "tracking_ids": np.asarray(ids),
            "box3d_lidar": np.asarray(det["box3d_lidar"])[keep],
            "label_preds": np.asarray(det["label_preds"])[keep],
            "scores": np.asarray(det["scores"])[keep],
        }

    os.makedirs(args.work_dir, exist_ok=True)
    out_path = os.path.join(args.work_dir, "tracking_result.pkl")
    with open(out_path, "wb") as f:
        pickle.dump(results, f)
    print(f"tracked {len(tokens)} frames -> {out_path}")
    print("For official metrics, convert with tools/create_data_waymo.py "
          "--to-bin and run the waymo-open-dataset "
          "compute_tracking_metrics_main binary (toolkit required).")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
