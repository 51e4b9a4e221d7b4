"""Segmentation evaluation entry point of the PyTorch port: point-level val
mIoU through the voxelization's inverse map.

Counterpart of tools/seg_evaluate.py (reference segmentation/evaluate.py:
33-305): restores a checkpoint of `link_tpu_torch/train/checkpoint.py`,
runs the val or test split of the SemanticKITTI tree at `dataset.root` (or
synthetic val scans with `--synthetic`) one scan at a time at the config's
capacities x 1.6 (full scans, uncapped), maps each voxel's argmax back to
the scan's points (trainers.py:84-103) and reports the mIoU (val only: the
test split has no labels). `--tta N` votes over N z-rotations of the raw
cloud: each rotation is voxelized anew, its softmax mapped to the points
through its own inverse map, the N summed and the argmax taken.
`--save-labels` writes SemanticKITTI submission `.label` files through the
inverse class map (test.py:34-260): `<dir>/<seq>/predictions/<n>.label` for
a scan of the tree, `<dir>/<n>.label` for a synthetic one. Each forward is
audited against the capacities, and the tool warns when a level overflowed
(the device path clamps silently).

Usage:
  python3 -m link_tpu_torch.tools.seg_evaluate \
      configs/semantic_kitti/linkunet/default.yaml run/best.pt \
      [--split val|test] [--tta N] [--synthetic] [--limit N] \
      [--save-labels DIR] [--device cpu] [key=value ...]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data.collate import audit_capacities, collate_scans, to_sparse_tensor
from ..data.semantic_kitti import (SemanticKITTI, SyntheticSemanticKITTI,
                                   dataset_root, inverse_label_lut,
                                   process_scan)
from ..models import builder
from ..train import trainer as T
from ..train.checkpoint import load_checkpoint
from ..train.metrics import MeanIoU, iou_counters
from ..utils.config import load_config

CAPACITY_FACTOR = 1.6      # eval capacities over the config's (full scans)
FULL_SCAN = 10 ** 9        # num_points that caps nothing


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("checkpoint")
    ap.add_argument("--split", default="val", choices=["val", "test"])
    ap.add_argument("--synthetic", action="store_true",
                    help="use the synthetic val split (no real data needed)")
    ap.add_argument("--save-labels", default=None,
                    help="directory for submission .label dumps")
    ap.add_argument("--tta", type=int, default=0,
                    help="N-way rotation voting: sum the point softmax over "
                         "N z-rotations of the raw cloud (0: no voting)")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("overrides", nargs="*")
    # key=value overrides may follow the options (older Pythons' argparse
    # leaves them unmatched with parse_args)
    return ap.parse_intermixed_args(argv)


def rotate_z(points: np.ndarray, theta: float) -> np.ndarray:
    """The cloud turned by `theta` about z (the JAX tool's vote rotation,
    in float32)."""
    rot = np.array([[np.cos(theta), np.sin(theta), 0],
                    [-np.sin(theta), np.cos(theta), 0],
                    [0, 0, 1]], np.float32)
    out = points.copy()
    out[:, :3] = out[:, :3] @ rot
    return out


def tta_scans(points: np.ndarray, labels: np.ndarray, voxel_size: float,
              votes: int):
    """The `votes` voxelized rotations of one raw cloud, at angles 2 pi v /
    votes, uncapped."""
    for v in range(votes):
        yield process_scan(rotate_z(points, 2 * np.pi * v / votes), labels,
                           voxel_size, FULL_SCAN, False)


def point_probs(model: torch.nn.Module, scan, caps) -> torch.Tensor:
    """Softmax of one voxelized scan's logits, taken to its points through
    the scan's inverse map: (points, classes) float32 on the model's
    device."""
    device = next(model.parameters()).device
    st = to_sparse_tensor(collate_scans([scan], caps[0]), device)
    model.eval()
    with torch.inference_mode():
        probs = torch.softmax(model(st).float(), -1)
        inv = torch.from_numpy(scan["inverse_map"]).long().to(probs.device)
        return probs[inv]


def label_file(save_dir: str, scan_path: str) -> str:
    """Where the `.label` of `scan_path` goes: the submission layout
    `<seq>/predictions/` for a scan of the tree, flat otherwise."""
    name = os.path.basename(scan_path).replace(".bin", ".label")
    parts = os.path.normpath(scan_path).split(os.sep)
    if len(parts) >= 3 and parts[-2] == "velodyne":
        return os.path.join(save_dir, parts[-3], "predictions", name)
    return os.path.join(save_dir, name)


def evaluate(args) -> dict:
    """The entry point's body: prints as it goes and returns {"miou",
    "per_class" (None on the test split), "ms_per_scan", "scans", "step",
    "overflow_scans", "overflow", "label_files", "votes_finite" (with
    --tta: whether every scan's summed votes were finite)}."""
    cfg = load_config(args.config, args.overrides)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to evaluate "
                           "on the CPU")
    if args.tta < 0:
        raise ValueError(f"--tta {args.tta}: the number of votes is >= 0")
    if args.synthetic and (args.tta or args.split != "val"):
        raise ValueError("--synthetic has a val split of made scans only: "
                         "--tta and --split test read the raw scans of the "
                         "SemanticKITTI tree")
    num_classes, ignore = cfg.data.num_classes, cfg.data.ignore_label
    caps = tuple(int(c * CAPACITY_FACTOR) for c in cfg.model.capacities)
    model = builder.make_model(cfg, capacities=caps, device=device)
    if args.synthetic:
        ds = SyntheticSemanticKITTI(length=8, voxel_size=cfg.dataset.voxel_size,
                                    num_points=FULL_SCAN, split="val")
    else:
        ds = SemanticKITTI(dataset_root(cfg.dataset.root), args.split,
                           cfg.dataset.voxel_size, num_points=FULL_SCAN)
        print(f"SemanticKITTI {args.split} at {cfg.dataset.root}: "
              f"{len(ds)} scans", flush=True)

    # the checkpoint holds the optimizer's state too: restore into a state
    # of the same shape
    state = T.TrainState(model, builder.make_optimizer(
        cfg, model.parameters(), 0.0))
    load_checkpoint(args.checkpoint, state)
    print(f"restored {args.checkpoint} (step {state.step})", flush=True)

    scored = args.split == "val"
    miou = MeanIoU(num_classes, ignore)
    overflow = np.zeros(len(caps), np.int64)
    overflow_scans = 0
    lut = inverse_label_lut()
    ms, label_files = [], []
    votes_finite = True
    n = min(len(ds), args.limit) if args.limit else len(ds)
    for i in range(n):
        if args.tta:
            points, point_labels = ds.raw(i)
            scans = list(tta_scans(points, point_labels,
                                   cfg.dataset.voxel_size, args.tta))
        else:
            scans = [ds[i]]
            point_labels = scans[0]["point_labels"]
        over = np.zeros(len(caps), np.int64)
        for s in scans:
            over += audit_capacities(s["coords"], caps)
        if over.any():
            overflow += over
            overflow_scans += 1
        t0 = time.perf_counter()
        if args.tta:
            votes = sum(point_probs(model, s, caps) for s in scans)
            votes_finite &= bool(torch.isfinite(votes).all())
            point_preds = votes.argmax(-1).to(torch.int32).cpu().numpy()
        else:
            b = collate_scans(scans, caps[0])
            preds, _ = T.seg_eval_step(model, b, num_classes, ignore)
            preds = preds.cpu().numpy()[:int(b["nnz"])]
            point_preds = preds[scans[0]["inverse_map"]]
        ms.append((time.perf_counter() - t0) * 1e3)   # waited for the device

        if scored:
            miou.update(iou_counters(
                torch.from_numpy(point_preds),
                torch.from_numpy(point_labels.astype(np.int32)),
                torch.ones(len(point_labels), dtype=torch.bool), num_classes,
                ignore))
        if args.save_labels:
            path = label_file(args.save_labels, ds.files[i] if args.tta
                              else scans[0]["file_name"])
            os.makedirs(os.path.dirname(path), exist_ok=True)
            lut[point_preds].tofile(path)
            label_files.append(path)
        if (i + 1) % 50 == 0:
            print(f"[{i + 1}/{n}]" + (f" running mIoU="
                                      f"{miou.compute() * 100:.2f}"
                                      if scored else ""), flush=True)

    if overflow_scans:
        print(f"WARNING: {overflow_scans}/{n} scans overflowed the capacity "
              f"schedule {caps}; dropped voxels per level: "
              f"{overflow.tolist()} — raise capacities or accept the clamp "
              "(predictions for dropped voxels fall back to the ignore "
              "class).")
    print(f"{n} scans on {device}: {float(np.median(ms)):.2f} ms per scan "
          f"(median; {max(args.tta, 1)} forward(s), argmax and copies)")
    out = {"miou": miou.compute() if scored else None,
           "per_class": miou.per_class() if scored else None,
           "ms_per_scan": ms, "scans": n, "step": state.step,
           "overflow_scans": overflow_scans, "overflow": overflow.tolist(),
           "label_files": label_files,
           "votes_finite": votes_finite if args.tta else None}
    if scored:
        print(f"point-level val mIoU: {out['miou'] * 100:.2f}")
        for ci, iou in enumerate(out["per_class"]):
            print(f"  class {ci}: {iou * 100:.2f}")
    return out


def main(argv=None) -> int:
    evaluate(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
