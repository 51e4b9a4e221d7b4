"""Segmentation evaluation entry point of the PyTorch port: point-level val
mIoU through the voxelization's inverse map.

Counterpart of tools/seg_evaluate.py (reference segmentation/evaluate.py:
33-305): restores a checkpoint of `link_tpu_torch/train/checkpoint.py`,
runs the val split one scan at a time at the config's capacities x 1.6
(full scans, uncapped), maps each voxel's argmax back to the scan's points
(trainers.py:84-103) and reports the mIoU; `--save-labels` writes
SemanticKITTI submission `.label` files through the inverse class map
(test.py:34-260). It also audits each batch against the capacities and
warns when a level overflowed (the device path clamps silently).

Usage:
  python3 -m link_tpu_torch.tools.seg_evaluate \
      configs/semantic_kitti/linkunet/default.yaml run/best.pt --synthetic \
      [--limit N] [--save-labels DIR] [--device cpu] [key=value ...]

Only the synthetic val split runs: the SemanticKITTI file reader is not
ported yet, and neither is rotation voting (`--tta`), which reads the raw
scans through it, nor the choice of split, since only the reader has a
test split.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data.collate import audit_capacities, collate_scans
from ..data.semantic_kitti import SyntheticSemanticKITTI
from ..models import builder
from ..train import trainer as T
from ..train.checkpoint import load_checkpoint
from ..train.metrics import MeanIoU, iou_counters
from ..utils.config import load_config

# learning map inverse (20 classes -> raw SemanticKITTI labels), for
# submissions
INVERSE_LABEL_MAP = {
    0: 0, 1: 10, 2: 11, 3: 15, 4: 18, 5: 20, 6: 30, 7: 31, 8: 32, 9: 40,
    10: 44, 11: 48, 12: 49, 13: 50, 14: 51, 15: 70, 16: 71, 17: 72, 18: 80,
    19: 81,
}
CAPACITY_FACTOR = 1.6      # eval capacities over the config's (full scans)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("checkpoint")
    ap.add_argument("--synthetic", action="store_true",
                    help="use the synthetic val split (no real data needed)")
    ap.add_argument("--save-labels", default=None,
                    help="directory for submission .label dumps")
    ap.add_argument("--tta", type=int, default=0,
                    help="N-way rotation voting (needs the SemanticKITTI "
                         "reader: not ported yet)")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("overrides", nargs="*")
    return ap.parse_args(argv)


def evaluate(args) -> dict:
    """The entry point's body: prints as it goes and returns {"miou",
    "per_class", "ms_per_scan", "scans", "step", "overflow_scans",
    "overflow"}."""
    cfg = load_config(args.config, args.overrides)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to evaluate "
                           "on the CPU")
    if not args.synthetic:
        raise NotImplementedError(
            "the SemanticKITTI file reader is not ported yet: pass "
            "--synthetic")
    if args.tta > 1:
        raise NotImplementedError(
            "--tta votes over rotations of the raw scans, which come from "
            "the SemanticKITTI file reader: not ported yet")
    num_classes, ignore = cfg.data.num_classes, cfg.data.ignore_label
    caps = tuple(int(c * CAPACITY_FACTOR) for c in cfg.model.capacities)
    model = builder.make_model(cfg, capacities=caps, device=device)
    ds = SyntheticSemanticKITTI(length=8, voxel_size=cfg.dataset.voxel_size,
                                num_points=10 ** 9, split="val")

    # the checkpoint holds the optimizer's state too: restore into a state
    # of the same shape
    state = T.TrainState(model, builder.make_optimizer(
        cfg, model.parameters(), 0.0))
    load_checkpoint(args.checkpoint, state)
    print(f"restored {args.checkpoint} (step {state.step})", flush=True)

    miou = MeanIoU(num_classes, ignore)
    overflow = np.zeros(len(caps), np.int64)
    overflow_scans = 0
    lut = np.zeros(len(INVERSE_LABEL_MAP), np.uint32)
    for k, v in INVERSE_LABEL_MAP.items():
        lut[k] = v
    ms = []
    n = min(len(ds), args.limit) if args.limit else len(ds)
    for i in range(n):
        scan = ds[i]
        b = collate_scans([scan], caps[0])
        nnz = int(b["nnz"])
        ov = audit_capacities(b["coords"][:nnz], caps)
        if any(ov):
            overflow += ov
            overflow_scans += 1
        t0 = time.perf_counter()
        preds, _ = T.seg_eval_step(model, b, num_classes, ignore)
        preds = preds.cpu().numpy()[:nnz]            # waits for the device
        ms.append((time.perf_counter() - t0) * 1e3)
        point_preds = preds[scan["inverse_map"]]

        labels = scan["point_labels"]
        miou.update(iou_counters(
            torch.from_numpy(point_preds), torch.from_numpy(labels),
            torch.ones(len(labels), dtype=torch.bool), num_classes, ignore))
        if args.save_labels:
            os.makedirs(args.save_labels, exist_ok=True)
            name = os.path.basename(scan["file_name"]).replace(".bin",
                                                               ".label")
            lut[point_preds].tofile(os.path.join(args.save_labels, name))
        if (i + 1) % 50 == 0:
            print(f"[{i + 1}/{n}] running mIoU={miou.compute() * 100:.2f}",
                  flush=True)

    if overflow_scans:
        print(f"WARNING: {overflow_scans}/{n} scans overflowed the capacity "
              f"schedule {caps}; dropped voxels per level: "
              f"{overflow.tolist()} — raise capacities or accept the clamp "
              "(predictions for dropped voxels fall back to the ignore "
              "class).")
    print(f"{n} scans on {device}: {float(np.median(ms)):.2f} ms per scan "
          "(median; forward, argmax and copies)")
    out = {"miou": miou.compute(), "per_class": miou.per_class(),
           "ms_per_scan": ms, "scans": n, "step": state.step,
           "overflow_scans": overflow_scans, "overflow": overflow.tolist()}
    print(f"point-level val mIoU: {out['miou'] * 100:.2f}")
    for ci, iou in enumerate(out["per_class"]):
        print(f"  class {ci}: {iou * 100:.2f}")
    return out


def main(argv=None) -> int:
    evaluate(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
