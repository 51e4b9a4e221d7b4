"""TTA driver of the PyTorch port: det_test over the 7 TTA rotations (each
double-flipped unless --no-double-flip), then the per-class rotated-NMS
fusion of the per-rotation prediction files.

Counterpart of tools/tta_fuse.py (reference detection/single_rot_test.sh,
fuse_rot_flip_results.sh and nms_better2.py:229-332: per-class weighted
rotated NMS of the result JSONs, top-500 cap). det_test has already rotated
each run's predictions back into the keyframe's lidar frame, so the fusion
happens there (the reference fuses in global coordinates, an equivalent
common frame).

Usage:
  python3 -m link_tpu_torch.tools.tta_fuse --out-dir runs/tta \
      [det_test options ...]                        # run and fuse
  python3 -m link_tpu_torch.tools.tta_fuse --out-dir runs/tta \
      --fuse-only runs/tta/rot_*.json               # fuse only
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

import numpy as np

from ..data.det_pipeline import NUSC_CLASSES
from ..eval import nuscenes_eval as NE
from ..eval.tta_fusion import TTA_ROT_ANGLES, fuse_sample


def run_rotations(out_dir, passthrough, double_flip):
    """det_test once per TTA angle into out_dir/rot_<angle>.json (a file
    that exists is kept); returns the paths."""
    paths = []
    for ang in TTA_ROT_ANGLES:
        out = os.path.join(out_dir, f"rot_{ang:+.2f}.json")
        if not os.path.exists(out):
            cmd = [sys.executable, "-m", "link_tpu_torch.tools.det_test",
                   "--tt-rotation", str(ang), "--out", out] + passthrough
            if double_flip:
                cmd.append("--double-flip")
            print("::", " ".join(cmd), flush=True)
            subprocess.run(cmd, check=True)
        paths.append(out)
    return paths


def fuse_files(paths, max_boxes=500):
    """The records of the prediction files fused per token
    (`fuse_sample`), with the first file's GT of each token."""
    runs_by_token = {}
    gt_by_token = {}
    for p in paths:
        with open(p) as f:
            recs = json.load(f)
        for r in recs:
            tok = r["token"]
            runs_by_token.setdefault(tok, []).append({
                "boxes": np.asarray(r["pred_boxes"],
                                    np.float64).reshape(-1, 9),
                "scores": np.asarray(r["pred_scores"], np.float64),
                "labels": np.asarray(r["pred_labels"], np.int64),
            })
            if "gt_boxes" in r and tok not in gt_by_token:
                gt_by_token[tok] = {
                    "gt_boxes": np.asarray(r["gt_boxes"], np.float64),
                    "gt_classes": np.asarray(r["gt_classes"], np.int64),
                }

    fused = []
    for tok, runs in runs_by_token.items():
        f = fuse_sample(runs, NUSC_CLASSES, max_boxes=max_boxes)
        rec = {"token": tok, "pred_boxes": f["boxes"],
               "pred_scores": f["scores"], "pred_labels": f["labels"]}
        if tok in gt_by_token:
            rec.update(gt_by_token[tok])
        fused.append(rec)
    return fused


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out-dir", default="runs/tta")
    ap.add_argument("--fuse-only", nargs="*", default=None,
                    help="skip running; fuse these prediction JSONs (none "
                         "given: out-dir/rot_*.json)")
    ap.add_argument("--no-double-flip", action="store_true",
                    help="rotation-only TTA (the reference runs each "
                         "rotation double-flipped)")
    ap.add_argument("--max-boxes", type=int, default=500)
    args, passthrough = ap.parse_known_args(argv)

    if args.fuse_only is not None:
        paths = args.fuse_only or sorted(
            glob.glob(os.path.join(args.out_dir, "rot_*.json")))
    else:
        os.makedirs(args.out_dir, exist_ok=True)
        paths = run_rotations(args.out_dir, passthrough,
                              double_flip=not args.no_double_flip)

    fused = fuse_files(paths, args.max_boxes)
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, "fused.json")
    with open(out, "w") as f:
        json.dump([{k: (v.tolist() if isinstance(v, np.ndarray) else v)
                    for k, v in s.items()} for s in fused], f)
    print(f"fused {len(paths)} runs -> {out} ({len(fused)} samples)")

    if fused and "gt_boxes" in fused[0]:
        gt_c, pr_c, sc_c, at_c = NE.group_by_class(fused)
        metrics = NE.evaluate_nuscenes(gt_c, pr_c, sc_c, attrs_by_class=at_c)
        print(f"TTA-fused mAP: {metrics['mean_ap'] * 100:.2f}  "
              f"NDS: {metrics['nds'] * 100:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
