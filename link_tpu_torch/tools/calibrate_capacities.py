"""Capacity calibration: scan a dataset and report per-stride-level voxel
counts, so that a capacity schedule is chosen with a known overflow risk.

Counterpart of tools/calibrate_capacities.py. The fixed-capacity design
drops voxels past a level's capacity silently (`coords.unique_coords`
clamps; `data.collate.audit_capacities` counts the drops); this tool makes
the trade-off explicit. It collates `--batch` scans at a time, as training
does, counts the unique voxels of each batch at strides 1, 2, 4, 8, 16
(`data.collate.level_unique_counts`), and suggests each level's capacity
as the largest count x 1.06, rounded up to a multiple of 256.

Usage:
  python3 -m link_tpu_torch.tools.calibrate_capacities --synthetic \
      --scans 32 --batch 2
  python3 -m link_tpu_torch.tools.calibrate_capacities \
      --root data/SemanticKITTI/dataset/sequences --split train
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np

from ..data.collate import level_unique_counts
from ..data.semantic_kitti import SemanticKITTI, SyntheticSemanticKITTI

LEVELS = 5
HEADROOM = 1.06
ROUND = 256


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="SemanticKITTI sequences directory")
    ap.add_argument("--split", default="train")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--scans", type=int, default=32)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--voxel-size", type=float, default=0.05)
    ap.add_argument("--num-points", type=int, default=80000)
    return ap.parse_args(argv)


def batch_counts(ds, scans: int, batch: int) -> np.ndarray:
    """(batches, LEVELS) unique-voxel counts of the first `scans` scans of
    `ds`, `batch` scans a batch (a last partial batch is left out)."""
    per_batch: List[List[int]] = []
    coords = []
    for i in range(min(len(ds), scans)):
        c = ds[i]["coords"]
        coords.append(np.concatenate(
            [c, np.full((len(c), 1), len(coords), np.int32)], 1))
        if len(coords) == batch:
            per_batch.append(level_unique_counts(np.concatenate(coords),
                                                 LEVELS))
            coords = []
    return np.asarray(per_batch, np.int64).reshape(-1, LEVELS)


def suggest(counts: np.ndarray) -> List[int]:
    """Each level's largest count x HEADROOM, rounded up to ROUND rows."""
    return [int(np.ceil(counts[:, lvl].max() * HEADROOM / ROUND) * ROUND)
            for lvl in range(counts.shape[1])]


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.synthetic:
        ds = SyntheticSemanticKITTI(length=args.scans,
                                    voxel_size=args.voxel_size,
                                    num_points=args.num_points,
                                    split=args.split)
    else:
        if not (args.root and os.path.isdir(args.root)):
            raise FileNotFoundError(
                f"--root {args.root!r} is not a directory: point it at the "
                "SemanticKITTI sequences or pass --synthetic")
        ds = SemanticKITTI(args.root, args.split, args.voxel_size,
                           args.num_points)
    counts = batch_counts(ds, args.scans, args.batch)
    if not len(counts):
        raise ValueError(f"fewer than --batch {args.batch} scans to count")
    print(f"{len(counts)} batches of {args.batch} scans, voxel "
          f"{args.voxel_size} m")
    print(f"{'level':>6} {'stride':>6} {'mean':>9} {'p50':>9} {'max':>9} "
          f"{'suggested cap':>14}")
    caps = suggest(counts)
    for lvl, cap in enumerate(caps):
        col = counts[:, lvl]
        print(f"{lvl:>6} {1 << lvl:>6} {col.mean():>9.0f} "
              f"{np.median(col):>9.0f} {col.max():>9} {cap:>14}")
    print(f"capacities: {caps}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
