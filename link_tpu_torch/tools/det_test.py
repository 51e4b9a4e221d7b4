"""Detection evaluation entry point of the PyTorch port: forward, decode,
rotated NMS, the nuScenes metrics (mAP, NDS, per-class AP) and latency.

Counterpart of tools/det_test.py (reference detection/tools/dist_test.py:
73-218): CenterPoint-ELKv3 (VoxelNet) over the val infos of a nuScenes tree
(`NuScenesDataset(mode="val")`, 10 sweeps) or synthetic frames, one frame a
forward at the 160k val voxel cap (capacity 163,840), the box decode, then
rotated NMS per task: on the host through the native library, or with
`--device-nms` on the card through the `rotated_nms` kernel. The metrics
come from `eval/nuscenes_eval` on the frames' unaugmented GT.

  --tt-rotation DEG  rotates the input cloud before voxelization and the
                     predictions back (`eval/tta_fusion.
                     rotate_predictions_back`), as the reference's
                     preprocess.py:153-157 and center_head.py:490-504;
  --double-flip      runs [orig, y-flip, x-flip, xy-flip] as one batch of 4
                     at 4 x the capacity and fuses the maps at decode
                     (`models/center_head.double_flip_fuse`);
  --speed-test       prints the mean latency of the middle third of the
                     frames (forward, decode, NMS on the card and the copy
                     of the kept rows to the host);
  --out FILE         writes the per-frame predictions (and GT) as JSON, the
                     input of tools/tta_fuse;
  --save-vis FILE    writes points, detections and GT for a viewer;
  --two-stage        refines each frame's proposals (after NMS, at most
                     500) with the RoI head over the neck's BEV map
                     (`models/two_stage.TwoStageRefinement`; reference
                     detectors/two_stage.py): 5-point BEV pooling, the
                     score sqrt(sigmoid(iou) * first score), the refined
                     boxes; its weights from --two-stage-checkpoint (the
                     `roi_head.pt` of tools/det_train_two_stage, which
                     implies --two-stage) or drawn from seed 1;
  --dcn-head         the DCN head (also a config's bbox_head.dcn_head);
  --dense-from-level L  the backbone's levels from L on run on a masked
                     dense grid (`models/scn.py`).

Usage:
  python3 -m link_tpu_torch.tools.det_test --checkpoint runs/det/latest.pt \
      [--config configs/nusc/voxelnet/...elkv3.py] [--info-path P] \
      [--root-path D] [--synthetic] [--limit N] [--double-flip] \
      [--tt-rotation DEG] [--dtype bfloat16] [--device-nms] [--out F] \
      [--two-stage [--two-stage-checkpoint roi_head.pt]] [--dcn-head] \
      [--dense-from-level L] [--device cpu]

Without the info pkl (and without --synthetic) the tool raises
FileNotFoundError naming the path.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np
import torch

from ..data import det_pipeline as dp
from ..data.nuscenes import NuScenesDataset, SyntheticNuScenes
from ..eval import nuscenes_eval as NE
from ..eval.tta_fusion import rotate_predictions_back
from ..inference import (DEFAULT_TEST_CFG, config_dcn_head,
                         config_test_cfg, host_nms, masked_rows)
from ..models import two_stage as TS
from ..models.center_head import decode_boxes, device_nms
from ..models.scn import det_capacities
from ..models.voxelnet import VoxelNet, report_rows_dropped

TEST_CFG = dict(DEFAULT_TEST_CFG)   # the JAX tool's TEST_CFG
GRID = (1440, 1440, 40)             # the grid of 0.075 m voxels
CAPACITY = 163840                   # level-0 rows of one frame
FLIP_GROUP = 4                      # [orig, y-flip, x-flip, xy-flip]
VAL_MAX_VOXELS = 160000
N_ROI = 500                         # the reference's NMS_POST_MAXSIZE
BEV_CHANNELS = 512                  # the neck's output


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=None,
                    help="reference-style py config; its test_cfg updates "
                         "TEST_CFG")
    ap.add_argument("--checkpoint", default=None,
                    help="a checkpoint of det_train (its model entry); "
                         "without it the weights are drawn from seed 0")
    ap.add_argument("--info-path", default="data/nuScenes/infos_val_10sweeps_"
                                           "withvelo_filter_True.pkl")
    ap.add_argument("--root-path", default="data/nuScenes")
    ap.add_argument("--synthetic", action="store_true",
                    help="synthetic frames (with GT) instead of the infos")
    ap.add_argument("--speed-test", action="store_true")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--tt-rotation", type=float, default=0.0,
                    help="TTA input rotation in degrees; predictions are "
                         "rotated back")
    ap.add_argument("--double-flip", action="store_true",
                    help="4-flip TTA in one batch, fused at decode")
    ap.add_argument("--two-stage", action="store_true",
                    help="RoI refinement second stage over the NMS "
                         "proposals")
    ap.add_argument("--two-stage-checkpoint", default=None,
                    help="roi_head.pt of det_train_two_stage (implies "
                         "--two-stage)")
    ap.add_argument("--dcn-head", action="store_true",
                    help="DCNSepHead instead of SepHead")
    ap.add_argument("--dense-from-level", type=int, default=None,
                    help="backbone levels >= L on a masked dense grid")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="model compute dtype (the box decode stays f32)")
    ap.add_argument("--device-nms", action="store_true",
                    help="rotated NMS on the card (the rotated_nms kernel)")
    ap.add_argument("--out", default=None, help="write predictions json")
    ap.add_argument("--save-vis", default=None,
                    help="write a visualization pkl (points, detections, GT)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def make_dataset(args):
    """The val infos (or synthetic frames with GT) with the TTA options."""
    tt_rot = float(np.deg2rad(args.tt_rotation))
    if args.synthetic:
        return SyntheticNuScenes(length=8, mode="train",
                                 max_voxels=VAL_MAX_VOXELS,
                                 tt_rotation=tt_rot,
                                 double_flip=args.double_flip)
    if not os.path.exists(args.info_path):
        raise FileNotFoundError(
            f"no nuScenes info pkl at {args.info_path!r}: make it with "
            "python3 -m link_tpu_torch.tools.create_data nuscenes_data_prep, "
            "or pass --synthetic")
    return NuScenesDataset(args.info_path, args.root_path, mode="val",
                           max_voxels=(120000, VAL_MAX_VOXELS),
                           tt_rotation=tt_rot, double_flip=args.double_flip)


class DetTest:
    """The model and the per-frame steps of det_test: `batch` collates a
    sample (with its flip variants under double flip), `forward` runs the
    model, the decode and device NMS on the card, `detections` brings the
    kept rows to the host (after host NMS) and `record` builds the frame's
    output record."""

    def __init__(self, args, device):
        self.args = args
        self.device = torch.device(device)
        self.cfg = dict(TEST_CFG)
        if args.config:
            self.cfg.update(config_test_cfg(args.config))
        self.n_batch = FLIP_GROUP if args.double_flip else 1
        self.cap = CAPACITY * self.n_batch
        state_dict = None
        if args.checkpoint:
            state_dict = torch.load(args.checkpoint, map_location="cpu",
                                    weights_only=True)["model"]
        gen = None if state_dict is not None else \
            torch.Generator().manual_seed(0)
        self.two_stage = bool(args.two_stage or args.two_stage_checkpoint)
        self.model = VoxelNet(num_input_features=5, batch_size=self.n_batch,
                              grid_shape=GRID,
                              capacities=det_capacities(CAPACITY,
                                                        self.n_batch),
                              dtype=args.dtype,
                              dcn_head=(args.dcn_head
                                        or config_dcn_head(args.config)),
                              return_bev=self.two_stage,
                              dense_from_level=args.dense_from_level,
                              device=self.device, generator=gen)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.model.eval()
        self.num_classes = [len(t) for t in self.model.tasks]
        self.refine, self.refine_ms = None, []
        if self.two_stage:
            self.refine = TS.TwoStageRefinement(
                bev_channels=BEV_CHANNELS,
                pc_start=tuple(self.cfg["pc_range"][:2]),
                voxel_size=tuple(self.cfg["voxel_size"][:2]),
                out_stride=self.cfg["out_size_factor"], device=self.device,
                generator=(None if args.two_stage_checkpoint
                           else torch.Generator().manual_seed(1)))
            if args.two_stage_checkpoint:
                self.refine.load_state_dict(torch.load(
                    args.two_stage_checkpoint, map_location="cpu",
                    weights_only=True)["roi_head"], strict=True)
            self.refine.eval()

    def batch(self, s):
        """Double flip: the group [orig, y-flip, x-flip, xy-flip] in one
        batch, in the order double_flip_fuse takes (the targets of a
        synthetic frame left out)."""
        if self.args.double_flip:
            keys = ("voxels", "coords_zyx", "num_points")
            group = [{k: s[k] for k in keys}] + list(s["flip_variants"])
        else:
            group = [s]
        return dp.collate_det(group, self.cap)

    def forward(self, batch):
        """Forward, decode (fused under double flip) and device NMS when
        asked for: per task (boxes, scores, labels, mask) of batch 1 on the
        device; with --two-stage also the neck's (B, C, H, W) map."""
        with torch.inference_mode():
            out = self.model(*dp.det_inputs(batch, self.device))
            preds, bev = out if self.two_stage else (out, None)
            outs = decode_boxes(preds, self.cfg, self.num_classes,
                                double_flip=self.args.double_flip)
            if self.args.device_nms:
                outs = device_nms(outs, self.cfg)
            return (outs, bev) if self.two_stage else outs

    def refine_proposals(self, bev, pb, ps):
        """The second stage over the first N_ROI proposals (det3d layout),
        padded with zero rows to N_ROI, on the original orientation's map
        (batch row 0): (scores, boxes) of those proposals. Appends its
        time, the copies included, to `refine_ms`."""
        t0 = time.perf_counter()
        k = min(len(pb), N_ROI)
        rois = np.zeros((N_ROI, 9), np.float32)
        scores = np.zeros(N_ROI, np.float32)
        rois[:k] = TS.reorder_to_roi_layout(pb[:k])
        scores[:k] = ps[:k]
        with torch.inference_mode():
            r = torch.from_numpy(rois).to(self.device)
            sc = torch.from_numpy(scores).to(self.device)
            # the neck emits (B, C, H, W); the refinement samples (H, W, C)
            iou, reg = self.refine(bev[0].permute(1, 2, 0), r, sc)
            s2 = TS.second_stage_score(iou, sc)
            boxes = TS.generate_refined_boxes(r, reg)
            s2, boxes = s2.cpu().numpy(), boxes.cpu().numpy()
        self.refine_ms.append((time.perf_counter() - t0) * 1e3)
        return s2[:k], TS.roi_layout_to_det3d(boxes)[:k]

    def detections(self, rows, bev=None):
        """`masked_rows` after the host's rotated NMS per task (none with
        device NMS, whose mask is the keep), refined by the second stage
        under --two-stage (`bev` the forward's map), the boxes rotated back
        under --tt-rotation: (boxes, scores, labels)."""
        det = host_nms(rows, self.cfg, self.args.device_nms)
        pb, ps, pl = det["box3d_lidar"], det["scores"], det["label_preds"]
        if self.two_stage and len(pb):
            ps, pb = self.refine_proposals(bev, pb, ps)
            pl = pl[:len(pb)]
        if self.args.tt_rotation != 0.0:
            pb = rotate_predictions_back(pb, np.deg2rad(self.args.tt_rotation))
        return pb, ps, pl

    def record(self, s, index, pb, ps, pl):
        rec = {"token": s.get("token", str(index)), "pred_boxes": pb,
               "pred_scores": ps, "pred_labels": pl}
        if "gt_boxes" in s:
            rec["gt_boxes"] = s["gt_boxes"]
            rec["gt_classes"] = s["gt_classes"]
            for k in ("gt_attributes", "gt_num_pts"):
                if k in s:
                    rec[k] = s[k]
        if self.args.save_vis:
            # the voxel-capped cloud from the voxel buffers: each voxel row
            # holds its first max_points raw points
            v, c = s["voxels"], s["num_points"]
            pts = np.concatenate([v[j, :c[j], :3] for j in range(len(c))]) \
                if len(c) else np.zeros((0, 3), np.float32)
            rec["_vis"] = {"points": pts,
                           "detections": {"box3d_lidar": pb, "scores": ps,
                                          "label_preds": pl},
                           "gt_boxes": s.get("gt_boxes")}
        return rec


def metrics_of(samples):
    """mAP, NDS and the per-class APs of the records (None without GT)."""
    if not samples or "gt_boxes" not in samples[0]:
        return None
    gt_c, pr_c, sc_c, at_c = NE.group_by_class(samples)
    return NE.evaluate_nuscenes(gt_c, pr_c, sc_c, attrs_by_class=at_c)


def _jsonable(rec):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in rec.items()}


def evaluate(args) -> dict:
    """Run det_test for parsed `args`: {"samples": the frames' records,
    "ms_per_frame": each frame's latency, "metrics": `metrics_of` (None
    without GT), and under --two-stage "refine_ms": the second stage's
    time in each frame that had proposals}; writes --out and --save-vis."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to evaluate on "
                           "the CPU")
    ds = make_dataset(args)
    run = DetTest(args, device)
    if args.checkpoint:
        print(f"restored {args.checkpoint}")

    n = min(len(ds), args.limit) if args.limit else len(ds)
    samples, latencies = [], []
    for i in range(n):
        s = ds[i]
        b = run.batch(s)
        t0 = time.perf_counter()
        outs, bev = run.forward(b) if run.two_stage else (run.forward(b),
                                                          None)
        rows = masked_rows(outs)                    # waits for the device
        latencies.append(time.perf_counter() - t0)
        samples.append(run.record(s, i, *run.detections(rows, bev)))
        if (i + 1) % 50 == 0:
            print(f"[{i + 1}/{n}]", flush=True)

    if args.speed_test and len(latencies) > 3:
        third = len(latencies) // 3
        mid = latencies[third:2 * third]
        print(f"latency (middle third): {np.mean(mid) * 1000:.1f} ms "
              f"({1 / np.mean(mid):.2f} samples/s)")
    print(f"{n} frames, {np.mean(latencies) * 1e3:.1f} ms per frame "
          f"(forward, decode, NMS on the card, copy)", flush=True)
    dropped = report_rows_dropped(run.model)

    if args.save_vis:
        os.makedirs(os.path.dirname(args.save_vis) or ".", exist_ok=True)
        with open(args.save_vis, "wb") as f:
            pickle.dump([s.pop("_vis") for s in samples], f)
        print("wrote", args.save_vis)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump([_jsonable(s) for s in samples], f)

    metrics = metrics_of(samples)
    if metrics is not None:
        print(f"mAP: {metrics['mean_ap'] * 100:.2f}  NDS: "
              f"{metrics['nds'] * 100:.2f}")
        for c, ap in metrics["class_aps"].items():
            print(f"  {c}: AP {ap * 100:.1f}")
    out = {"samples": samples,
           "ms_per_frame": [t * 1e3 for t in latencies], "metrics": metrics,
           "rows_dropped": list(dropped)}
    if run.two_stage:
        out["refine_ms"] = run.refine_ms
    return out


def main(argv=None) -> int:
    evaluate(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
