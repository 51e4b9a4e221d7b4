"""Streaming single-frame detection on the port.

Port of `tools/stream_inference.py`, the equivalent of the reference's
online inference nodes (detection/tools/single_infernece_ros.py,
multi_sweep_inference_ros.py) without the ROS dependency: one warm
`SingleFramePredictor` takes point clouds one at a time and writes one JSON
line per frame: {"token", "latency_ms" (the frame's `predict`, host clock),
"boxes", "scores", "labels"}.

    python3 -m link_tpu_torch.tools.stream_inference --synthetic 3
    python3 -m link_tpu_torch.tools.stream_inference --tiny --synthetic 2 \\
        --device cpu

Sources:
  --files a.bin b.npy ...   explicit list;
  --watch-dir DIR           poll DIR for new .bin/.npy files (ctrl-C stops);
  --synthetic N             generated frames (plumbing check);
  --ros TOPIC               a PointCloud2 topic (needs rospy and ros_numpy).
The model runs on --device (default cuda); --device-nms suppresses on the
device through the `rotated_nms` kernel instead of the host's native NMS.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

from ..inference import SingleFramePredictor

TINY = dict(capacity=4096, grid_shape=(48, 48, 40), max_voxels=4000,
            test_cfg=dict(pc_range=[-12, -12], voxel_size=[0.5, 0.5],
                          post_center_limit_range=[-15, -15, -10, 15, 15, 10],
                          nms_pre_max_size=200, nms_post_max_size=40,
                          max_per_img=100))


def load_points(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    return np.fromfile(path, np.float32).reshape(-1, 5)


def synthetic_points(rng: np.random.Generator, n: int = 30000) -> np.ndarray:
    """A frame of n points over the 54 m detection disc (the JAX tool's)."""
    r = np.sqrt(rng.uniform(1, 54 ** 2, n))
    th = rng.uniform(0, 2 * np.pi, n)
    return np.stack([r * np.cos(th), r * np.sin(th), rng.normal(-1, 0.8, n),
                     rng.uniform(0, 255, n), np.zeros(n)],
                    1).astype(np.float32)


def emit(out, token, det, t_ms):
    rec = {"token": token, "latency_ms": round(t_ms, 2),
           "boxes": det["box3d_lidar"].tolist(),
           "scores": det["scores"].tolist(),
           "labels": det["label_preds"].tolist()}
    out.write(json.dumps(rec) + "\n")
    out.flush()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--files", nargs="*", default=None)
    ap.add_argument("--watch-dir", default=None)
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--ros", default=None, help="PointCloud2 topic")
    ap.add_argument("--out", default=None, help="JSONL sink (default stdout)")
    ap.add_argument("--poll-s", type=float, default=0.2)
    ap.add_argument("--tiny", action="store_true",
                    help="small grid and capacities (plumbing check)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--device-nms", action="store_true",
                    help="rotated NMS on the device (the rotated_nms kernel)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    pred = SingleFramePredictor(config=args.config,
                                checkpoint=args.checkpoint,
                                device=args.device,
                                device_nms=args.device_nms,
                                **(TINY if args.tiny else {}))
    out = open(args.out, "w") if args.out else sys.stdout

    def run_one(token, pts):
        t0 = time.perf_counter()
        det = pred.predict(pts)
        emit(out, token, det, (time.perf_counter() - t0) * 1000)

    try:
        if args.synthetic:
            rng = np.random.default_rng(0)
            for i in range(args.synthetic):
                run_one(f"synthetic_{i}", synthetic_points(rng))
            return
        if args.files:
            for path in args.files:
                run_one(os.path.basename(path), load_points(path))
            return
        if args.watch_dir:
            watch(args.watch_dir, args.poll_s, run_one)
            return
        if args.ros:
            ros(args.ros, run_one)
            return
    finally:
        if args.out:
            out.close()
    raise SystemExit("need one of --files / --watch-dir / --synthetic / --ros")


def watch(directory: str, poll_s: float, run_one) -> None:
    seen = set()
    print(f"watching {directory} ...", file=sys.stderr)
    try:
        while True:
            for path in sorted(glob.glob(os.path.join(directory, "*.bin"))
                               + glob.glob(os.path.join(directory, "*.npy"))):
                if path not in seen:
                    seen.add(path)
                    run_one(os.path.basename(path), load_points(path))
            time.sleep(poll_s)
    except KeyboardInterrupt:
        return


def ros(topic: str, run_one) -> None:
    try:
        import rospy
        import ros_numpy
        from sensor_msgs.msg import PointCloud2
    except ImportError:
        raise SystemExit("rospy/ros_numpy not available: use --files, "
                         "--watch-dir or --synthetic instead")

    def cb(msg):
        arr = ros_numpy.numpify(msg)
        pts = np.stack([arr["x"], arr["y"], arr["z"],
                        arr.get("intensity", np.zeros(len(arr))),
                        np.zeros(len(arr))], 1).astype(np.float32)
        run_one(str(msg.header.stamp), pts)

    rospy.init_node("link_tpu_torch_inference")
    rospy.Subscriber(topic, PointCloud2, cb, queue_size=1, buff_size=2 ** 24)
    rospy.spin()


if __name__ == "__main__":
    main()
