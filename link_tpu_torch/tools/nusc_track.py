"""nuScenes tracking from detection results, in the PyTorch port.

A copy of tools/nusc_track.py: the equivalent of the reference's tracking
driver
(detection/tools/nusc_tracking/pub_test.py:35-151): build per-frame
metadata (token / timestamp / first-of-scene), run the CenterPoint
velocity tracker over each scene, write the nuScenes tracking-submission
JSON, and (devkit present) run the official TrackingEval.

Frames metadata sources, in priority order:
  --frames PATH           a frames_meta.json ({"frames": [{token,
                          timestamp, first}, ...]}) written earlier;
  --info PKL + no devkit  infos pkl from tools/create_data.py (token,
                          timestamp; scene breaks where the time gap
                          exceeds 1 s);
  --root + devkit         exact scene structure via nuscenes-devkit.

The detections are a submission JSON ({"results": {token: [...]}}), as
`eval/submission.write_submission` writes it from det_test's records (the
`--out` JSON of tools/det_test) and the infos (boxes in the global frame).
The devkit steps (`--root` frames, `--evaluate`) import the nuscenes-devkit
when they run; the port does not depend on it.

Usage:
  python3 -m link_tpu_torch.tools.nusc_track --detections sub.json \
      --work-dir runs/track --info infos_val_10sweeps_withvelo_filter_True.pkl
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time


def frames_from_devkit(root: str, version: str):
    from nuscenes import NuScenes
    from nuscenes.utils import splits
    nusc = NuScenes(version=version, dataroot=root, verbose=True)
    scenes = splits.val if version == "v1.0-trainval" else splits.test
    frames = []
    for sample in nusc.sample:
        name = nusc.get("scene", sample["scene_token"])["name"]
        if name not in scenes:
            continue
        frames.append({"token": sample["token"],
                       "timestamp": sample["timestamp"] * 1e-6,
                       "first": sample["prev"] == ""})
    return frames


def frames_from_infos(info_path: str, gap_s: float = 1.0):
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    infos = sorted(infos, key=lambda x: x["timestamp"])
    frames, last = [], None
    for info in infos:
        ts = float(info["timestamp"]) * (1e-6 if info["timestamp"] > 1e12
                                         else 1.0)
        frames.append({"token": info["token"], "timestamp": ts,
                       "first": last is None or ts - last > gap_s})
        last = ts
    return frames


def run_tracking(predictions, frames, max_age=3, hungarian=False):
    from ..tracking import CenterTracker
    tracker = CenterTracker(max_age=max_age, hungarian=hungarian)
    annos = {}
    last_ts = 0.0
    for fr in frames:
        token = fr["token"]
        if fr["first"]:
            tracker.reset()
            last_ts = fr["timestamp"]
        time_lag = fr["timestamp"] - last_ts
        last_ts = fr["timestamp"]
        outputs = tracker.step(predictions.get(token, []), time_lag)
        annos[token] = [{
            "sample_token": token,
            "translation": item["translation"],
            "size": item["size"],
            "rotation": item["rotation"],
            "velocity": item["velocity"],
            "tracking_id": str(item["tracking_id"]),
            "tracking_name": item["detection_name"],
            "tracking_score": item["detection_score"],
        } for item in outputs if item["active"] > 0]
    return annos


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--detections", required=True,
                    help="detection submission JSON (results dict)")
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--frames", help="frames_meta.json path")
    ap.add_argument("--info", help="infos pkl (fallback frame source)")
    ap.add_argument("--root", help="nuScenes root (devkit frame source)")
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--max-age", type=int, default=3)
    ap.add_argument("--hungarian", action="store_true")
    ap.add_argument("--evaluate", action="store_true",
                    help="run the devkit TrackingEval afterwards")
    args = ap.parse_args(argv)

    with open(args.detections) as f:
        predictions = json.load(f)["results"]

    if args.frames:
        with open(args.frames) as f:
            frames = json.load(f)["frames"]
    elif args.info:
        frames = frames_from_infos(args.info)
    elif args.root:
        frames = frames_from_devkit(args.root, args.version)
    else:
        raise SystemExit("need one of --frames / --info / --root")

    t0 = time.time()
    results = run_tracking(predictions, frames, args.max_age, args.hungarian)
    dt = time.time() - t0
    print(f"tracked {len(frames)} frames in {dt:.2f}s "
          f"({len(frames) / max(dt, 1e-9):.1f} FPS)")

    os.makedirs(args.work_dir, exist_ok=True)
    out = {"results": results,
           "meta": {"use_camera": False, "use_lidar": True,
                    "use_radar": False, "use_map": False,
                    "use_external": False}}
    out_path = os.path.join(args.work_dir, "tracking_result.json")
    with open(out_path, "w") as f:
        json.dump(out, f)
    print("wrote", out_path)

    if args.evaluate:
        try:
            from nuscenes.eval.common.config import config_factory
            from nuscenes.eval.tracking.evaluate import TrackingEval
        except ImportError:
            raise SystemExit("nuscenes-devkit not available for --evaluate")
        cfg = config_factory("tracking_nips_2019")
        TrackingEval(config=cfg, result_path=out_path, eval_set="val",
                     output_dir=args.work_dir, verbose=True,
                     nusc_version=args.version,
                     nusc_dataroot=args.root).main()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
