"""BEV visualization of point clouds, GT boxes, and detections, in the
PyTorch port.

A copy of tools/demo.py: the equivalent of the reference's visualization
tooling (detection/tools/visual.py + demo_utils.visual:284-312): draw a
bird's-eye-view figure — distance-colored points, red GT boxes, blue
predictions above the confidence threshold — and save PNGs. matplotlib
(headless Agg, imported when `main` runs; the port does not depend on it)
replaces the reference's open3d window.

Inputs:
  --vis PKL      list of {points, detections{box3d_lidar|boxes, scores},
                 [gt_boxes]} dicts (the reference visual.py format;
                 produce one with link_tpu_torch.tools.det_test
                 --save-vis);
  --points FILE  a single .bin (float32 rows x,y,z,...) or .npy cloud;
  --synthetic    generated beam-geometry frames with GT boxes.

To visualize model predictions, first run det_test to produce a
detections file, then pass it here via --vis.

Usage:
  python3 -m link_tpu_torch.tools.demo --vis vis.pkl --out-dir demo
  python3 -m link_tpu_torch.tools.demo --synthetic --num-frames 2
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def box_corners_bev(boxes: np.ndarray) -> np.ndarray:
    """(N, >=7) det3d boxes -> (N, 4, 2) BEV corner loops."""
    from ..ops.box_np import center_to_corner_box2d
    boxes = np.asarray(boxes)
    return center_to_corner_box2d(boxes[:, :2], boxes[:, 3:5],
                                  boxes[:, -1])


def draw_bev(ax, points, gt_boxes=None, det_boxes=None, det_scores=None,
             eval_range=54.0, conf_th=0.5):
    points = np.asarray(points)
    d = np.sqrt((points[:, :2] ** 2).sum(1))
    keep = d > 3.0                      # remove ego returns
    pts = points[keep]
    colors = np.minimum(1.0, d[keep] / eval_range)
    ax.scatter(pts[:, 0], pts[:, 1], c=colors, s=0.2, cmap="viridis")

    def _loops(boxes, color, lw):
        for c in box_corners_bev(boxes):
            loop = np.concatenate([c, c[:1]])
            ax.plot(loop[:, 0], loop[:, 1], color=color, linewidth=lw)

    if gt_boxes is not None and len(gt_boxes):
        _loops(gt_boxes, "r", 2.0)
    if det_boxes is not None and len(det_boxes):
        det_boxes = np.asarray(det_boxes)
        if det_scores is not None:
            det_boxes = det_boxes[np.asarray(det_scores) >= conf_th]
        if len(det_boxes):
            _loops(det_boxes, "b", 1.0)
    lim = eval_range + 3
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_axis_off()


def synthetic_frame(seed: int):
    rng = np.random.default_rng(seed)
    n = 30000
    r = np.sqrt(rng.uniform(1, 54 ** 2, n))
    th = rng.uniform(0, 2 * np.pi, n)
    z = rng.normal(-1.0, 0.8, n)
    pts = np.stack([r * np.cos(th), r * np.sin(th), z], 1).astype(np.float32)
    n_obj = int(rng.integers(5, 20))
    boxes = np.zeros((n_obj, 9), np.float32)
    boxes[:, 0:2] = rng.uniform(-45, 45, (n_obj, 2))
    boxes[:, 2] = rng.uniform(-1.5, 0.5, n_obj)
    boxes[:, 3:6] = rng.uniform(1.0, 4.0, (n_obj, 3))
    boxes[:, 8] = rng.uniform(-np.pi, np.pi, n_obj)
    return {"points": pts, "gt_boxes": boxes, "detections": None}


def load_frames(args):
    if args.vis:
        with open(args.vis, "rb") as f:
            return pickle.load(f)
    if args.points:
        if args.points.endswith(".npy"):
            pts = np.load(args.points)
        else:
            pts = np.fromfile(args.points, np.float32).reshape(-1, 5)
        return [{"points": pts, "gt_boxes": None, "detections": None}]
    return [synthetic_frame(i) for i in range(args.num_frames)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vis", help="visualization pkl (points+detections)")
    ap.add_argument("--points", help=".bin (float32 x,y,z,i,..) or .npy")
    ap.add_argument("--out-dir", default="demo")
    ap.add_argument("--thresh", type=float, default=0.5)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--num-frames", type=int, default=1)
    args = ap.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(args.out_dir, exist_ok=True)
    for i, fr in enumerate(load_frames(args)):
        det = fr.get("detections") or {}
        det_boxes = det.get("box3d_lidar", det.get("boxes"))
        det_scores = det.get("scores")
        _, ax = plt.subplots(1, 1, figsize=(9, 9), dpi=200)
        draw_bev(ax, fr["points"], fr.get("gt_boxes"), det_boxes,
                 det_scores, conf_th=args.thresh)
        path = os.path.join(args.out_dir, f"file{i:02d}.png")
        plt.savefig(path)
        plt.close()
        print("wrote", path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
