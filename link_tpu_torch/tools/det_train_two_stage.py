"""Two-stage fine-tuning of the PyTorch port: the first stage frozen, the
RoI refinement head trained on its proposals.

Counterpart of tools/det_train_two_stage.py (reference
detection/det3d/models/detectors/two_stage.py with freeze=True, and the
two_stage *_ft_6epoch_freeze configs): per frame, at batch 1 and the
tool's own cap of 131,072 voxel rows, the CenterPoint-ELKv3 first stage
runs in eval mode without gradients (weights from a det_train checkpoint,
or seed 0), its boxes are decoded and pass the host's rotated NMS per
task (`ops/nms.rotate_nms_pcdet`, the native library);
`models/two_stage.assign_roi_targets` samples 128 rois of them, and the
RoI head (`TwoStageRefinement`, seed 1) takes one step of BCE(iou) + L1
(canonical residuals) under one-cycle Adam (weight decay 0.01, clip 35).
With --gt-proposals the proposals also hold the frame's GT boxes jittered
by N(0, 0.1): foreground supervision when the first stage is untrained.
The host's draws (jitter, sampling) come from one
`np.random.default_rng(0)` in the JAX tool's order.

Writes `<run-dir>/roi_head.pt` ({"roi_head": the refinement's state_dict,
"step": steps taken}), which det_test reads with --two-stage-checkpoint,
and `<run-dir>/metrics.jsonl` (one record a logged step).

Usage:
  python3 -m link_tpu_torch.tools.det_train_two_stage \\
      [--checkpoint runs/det/latest.pt] [--info-path P --root-path D | \\
      --synthetic] [--gt-proposals] [--steps N] [--epochs 6] [--lr 3e-4] \\
      [--run-dir runs/two_stage] [--device cpu]

Without the info pkl (and without --synthetic) the tool raises
FileNotFoundError naming the path (the JAX tool falls back to synthetic
frames).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data import det_pipeline as dp
from ..data.nuscenes import NuScenesDataset, SyntheticNuScenes
from ..inference import DEFAULT_TEST_CFG, masked_rows
from ..models import two_stage as TS
from ..models.center_head import decode_boxes
from ..models.scn import det_capacities
from ..models.voxelnet import VoxelNet
from ..ops.nms import rotate_nms_pcdet
from ..train import det_trainer as DT
from ..train import schedules
from ..utils.logging import MetricsLogger

TEST_CFG = {k: v for k, v in DEFAULT_TEST_CFG.items() if k != "max_per_img"}
GRID = (1440, 1440, 40)
CAPACITY = 131072           # level-0 rows of the tool's batch of one frame
BEV_CHANNELS = 512
LOG_EVERY = 10


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", default=None,
                    help="first-stage checkpoint of det_train (frozen); "
                         "without it the first stage is seed 0's")
    ap.add_argument("--info-path", default="data/nuScenes/infos_train_"
                                           "10sweeps_withvelo_filter_True.pkl")
    ap.add_argument("--root-path", default="data/nuScenes")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--gt-proposals", action="store_true",
                    help="add the GT boxes, jittered, to the proposals")
    ap.add_argument("--steps", type=int, default=0, help="0 = one epoch")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--run-dir", default="runs/two_stage")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def make_dataset(args):
    """The train infos, or 16 synthetic frames."""
    if args.synthetic:
        return SyntheticNuScenes(length=16, mode="train", max_voxels=120000)
    if not os.path.exists(args.info_path):
        raise FileNotFoundError(
            f"no nuScenes info pkl at {args.info_path!r}: make it with "
            "python3 -m link_tpu_torch.tools.create_data nuscenes_data_prep, "
            "or pass --synthetic")
    return NuScenesDataset(args.info_path, args.root_path, mode="train",
                           max_voxels=(120000, 160000))


def first_stage_model(checkpoint, device) -> VoxelNet:
    """The frozen VoxelNet at batch 1 and CAPACITY, returning the neck's
    map beside the head's; eval mode, no parameter requires a gradient."""
    state_dict = None if checkpoint is None else torch.load(
        checkpoint, map_location="cpu", weights_only=True)["model"]
    model = VoxelNet(num_input_features=5, batch_size=1, grid_shape=GRID,
                     capacities=det_capacities(CAPACITY, 1),
                     return_bev=True, device=device,
                     generator=(torch.Generator().manual_seed(0)
                                if state_dict is None else None))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model.eval().requires_grad_(False)
    return model


def proposals(model, batch, device):
    """First stage on one collated frame: the boxes (det3d layout), scores
    and labels kept by the host's rotated NMS per task, concatenated, and
    the neck's (H, W, C) map."""
    with torch.no_grad():
        preds, bev = model(*dp.det_inputs(batch, device))
        decoded = decode_boxes(preds, TEST_CFG,
                               [len(t) for t in model.tasks])
    boxes_l, scores_l, labels_l = [], [], []
    for bx, sc, lb in masked_rows(decoded):
        if not len(bx):
            continue
        keep = rotate_nms_pcdet(bx[:, [0, 1, 2, 3, 4, 5, 8]], sc,
                                thresh=TEST_CFG["nms_iou_threshold"],
                                pre_maxsize=TEST_CFG["nms_pre_max_size"],
                                post_max_size=TEST_CFG["nms_post_max_size"])
        boxes_l.append(bx[keep])
        scores_l.append(sc[keep])
        labels_l.append(lb[keep])
    pb = np.concatenate(boxes_l) if boxes_l else np.zeros((0, 9), np.float32)
    ps = np.concatenate(scores_l) if scores_l else np.zeros(0, np.float32)
    pl = np.concatenate(labels_l) if labels_l else np.zeros(0, np.int64)
    return pb, ps, pl, bev[0].permute(1, 2, 0)


def refine_step(refine, opt, bev0, t, device):
    """One train step of the refinement on one frame's assigned targets
    `t` (`assign_roi_targets`): (loss, cls loss, reg loss), 0-d tensors."""
    def dev(key):
        return torch.from_numpy(np.asarray(t[key])).to(device)

    refine.train()
    opt.zero_grad(set_to_none=True)
    iou, reg = refine(bev0, dev("rois"), dev("roi_scores"))
    cl, rl = TS.roi_losses(iou, reg, dev("cls_labels"), dev("gt_of_rois"),
                           dev("reg_mask"))
    loss = cl + rl
    loss.backward()
    opt.step()
    return loss.detach(), cl.detach(), rl.detach()


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to train on "
                           "the CPU")
    ds = make_dataset(args)
    model = first_stage_model(args.checkpoint, device)
    if args.checkpoint:
        print(f"restored first stage {args.checkpoint}")
    refine = TS.TwoStageRefinement(
        bev_channels=BEV_CHANNELS,
        pc_start=tuple(TEST_CFG["pc_range"][:2]),
        voxel_size=tuple(TEST_CFG["voxel_size"][:2]),
        out_stride=TEST_CFG["out_size_factor"], device=device,
        generator=torch.Generator().manual_seed(1))

    steps_per_epoch = args.steps or len(ds)
    lr_fn, mom_fn = schedules.one_cycle(args.lr,
                                        steps_per_epoch * args.epochs)
    opt = DT.OneCycleAdam(refine.parameters(), lr_fn, mom_fn,
                          weight_decay=0.01, grad_clip=35.0)
    os.makedirs(args.run_dir, exist_ok=True)
    jlog = MetricsLogger(args.run_dir, interval=1)

    rng = np.random.default_rng(0)
    step = 0
    t0 = time.time()
    for epoch in range(args.epochs):
        for i in range(steps_per_epoch):
            s = ds[i % len(ds)]
            pb, ps, pl, bev0 = proposals(model, dp.collate_det([s], CAPACITY),
                                         device)
            if not len(pb) and not args.gt_proposals:
                continue
            if args.gt_proposals and len(s["gt_boxes"]):
                jit = s["gt_boxes"] + rng.normal(
                    0, 0.1, s["gt_boxes"].shape).astype(np.float32)
                pb = np.concatenate([pb, jit]) if len(pb) else jit
                ps = np.concatenate([ps, np.full(len(jit), 0.5, np.float32)])
                pl = np.concatenate([pl, s["gt_classes"].astype(pl.dtype)])
            t = TS.assign_roi_targets(TS.reorder_to_roi_layout(pb), ps, pl,
                                      s["gt_boxes"], s["gt_classes"], rng)
            loss, cl, rl = refine_step(refine, opt, bev0, t, device)
            step += 1
            if step % LOG_EVERY == 0:
                rec = {"epoch": epoch, "step": step, "loss": float(loss),
                       "cls_loss": float(cl), "reg_loss": float(rl),
                       "s_per_step": (time.time() - t0) / step}
                jlog.log(rec)
                print(f"e{epoch} s{step} loss={rec['loss']:.4f} "
                      f"cls={rec['cls_loss']:.4f} reg={rec['reg_loss']:.4f} "
                      f"({rec['s_per_step']:.2f}s/it)", flush=True)

    path = os.path.join(args.run_dir, "roi_head.pt")
    torch.save({"roi_head": refine.state_dict(), "step": step}, path)
    print(f"saved {path} ({step} steps)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
