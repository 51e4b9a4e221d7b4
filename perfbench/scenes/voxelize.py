"""What a SemanticKITTI training loader's worker makes of a scan: the
published augmentation (a rotation about z, a scale in [0.95, 1.05] and
one of four flips), quantization to the voxel grid (coordinates rounded,
shifted to start at 0, duplicates dropped, each voxel keeping its first
point's features and label), and a random subset of `num_points` voxels
when there are more (LinK's SemanticKITTI reader; torchsparse's
`sparse_quantize`). Rows come out in (z, y, x) key order, the order the
port's collation expects."""

from __future__ import annotations

from typing import Dict

import numpy as np


def augment(points: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    theta = rng.uniform(0, 2 * np.pi)
    scale = rng.uniform(0.95, 1.05)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    out = points.astype(np.float64, copy=True)
    out[:, :3] = out[:, :3] @ rot * scale
    flip = rng.integers(4)
    if flip in (1, 3):
        out[:, 0] = -out[:, 0]
    if flip in (2, 3):
        out[:, 1] = -out[:, 1]
    return out.astype(np.float32)


def quantize(points: np.ndarray, labels: np.ndarray, voxel: float,
             num_points: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    pc = np.round(points[:, :3] / voxel).astype(np.int64)
    pc -= pc.min(0, keepdims=True)
    key = (pc[:, 2] << 40) | (pc[:, 1] << 20) | pc[:, 0]
    _, first = np.unique(key, return_index=True)
    if len(first) > num_points:
        first = np.sort(rng.choice(first, num_points, replace=False))
    c = pc[first]
    order = np.lexsort((c[:, 0], c[:, 1], c[:, 2]))
    first = first[order]
    return {"coords": pc[first].astype(np.int32),
            "feats": points[first].astype(np.float32),
            "labels": labels[first].astype(np.int32)}


def train_sample(scan: Dict[str, np.ndarray], voxel: float, num_points: int,
                 rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """One augmented, quantized training scan: coords (N, 3) int32, feats
    (N, 4) float32 (x, y, z, reflectance of the voxel's point), labels (N,)
    int32."""
    return quantize(augment(scan["points"], rng), scan["labels"], voxel,
                    num_points, rng)
