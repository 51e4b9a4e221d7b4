"""SemanticKITTI: the file reader and synthetic scans, host-side NumPy.

A copy of `link_tpu/data/semantic_kitti.py` (which itself follows the
reference segmentation/core/datasets/semantic_kitti.py:99-344), kept here
so the port imports nothing of the JAX package. Same semantics and the same
random stream per seed:
  * sequence splits train 00-10 without 08 / val 08 / test 11-21, read from
    `<root>/<seq>/velodyne/*.bin` and `<root>/<seq>/labels/*.label`;
  * label remap LUT (raw & 0xFFFF -> 20 classes, moving classes folded),
    and its inverse for submission files;
  * train aug: random z-rotation, scale U[0.95, 1.05], 4-way flip;
  * voxelization: round(xyz / voxel_size), subtract per-scan min, dedup
    keeping the first point per voxel;
  * train cap `num_points` voxels via random choice;
  * voxels emitted in pack-key order (batch, z, y, x).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

# semantic-kitti.yaml learning_map (reference semantic_kitti.py:16-93)
LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

# learning map inverse (20 classes -> raw SemanticKITTI labels), for
# submissions
INVERSE_LABEL_MAP = {
    0: 0, 1: 10, 2: 11, 3: 15, 4: 18, 5: 20, 6: 30, 7: 31, 8: 32, 9: 40,
    10: 44, 11: 48, 12: 49, 13: 50, 14: 51, 15: 70, 16: 71, 17: 72, 18: 80,
    19: 81,
}

CLASS_NAMES = [
    "unlabeled", "car", "bicycle", "motorcycle", "truck", "other-vehicle",
    "person", "bicyclist", "motorcyclist", "road", "parking", "sidewalk",
    "other-ground", "building", "fence", "vegetation", "trunk", "terrain",
    "pole", "traffic-sign",
]

NUM_CLASSES = 20
IGNORE_LABEL = 0

TRAIN_SEQS = ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"]
VAL_SEQS = ["08"]
TEST_SEQS = ["11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21"]

# Static coordinate-domain bound in meters for the (min-shifted) quantized
# coords process_scan emits: 2 * 80 m * 1.05 horizontally, < 22 m in z.
GRID_EXTENT_M = (179.2, 179.2, 22.4)


def grid_extent(voxel_size: float = 0.05, batch_size: int = 1):
    """(nx, ny, nz, nb) static domain bound at a given quantization, e.g.
    (3584, 3584, 448, 1) at 0.05 m."""
    return tuple(int(np.ceil(m / voxel_size)) for m in GRID_EXTENT_M) + (
        int(batch_size),)


def build_label_map() -> np.ndarray:
    """Raw label (& 0xFFFF) -> class LUT; unknown raw labels map to 255."""
    lut = np.full(260, 255, np.int64)
    for k, v in LEARNING_MAP.items():
        lut[k] = v
    return lut


def inverse_label_lut() -> np.ndarray:
    """Class -> raw SemanticKITTI label, uint32, for `.label` files."""
    lut = np.zeros(NUM_CLASSES, np.uint32)
    for k, v in INVERSE_LABEL_MAP.items():
        lut[k] = v
    return lut


def ravel_hash(x: np.ndarray) -> np.ndarray:
    """torchsparse utils/quantize.py:10-21."""
    assert x.ndim == 2
    x = x - np.min(x, axis=0)
    x = x.astype(np.uint64, copy=False)
    xmax = np.max(x, axis=0).astype(np.uint64) + 1
    h = np.zeros(x.shape[0], dtype=np.uint64)
    for k in range(x.shape[1] - 1):
        h += x[:, k]
        h *= xmax[k + 1]
    h += x[:, -1]
    return h


def sparse_quantize(coords: np.ndarray):
    """Dedup int voxel coords; returns (coords, index, inverse)."""
    _, indices, inverse = np.unique(ravel_hash(coords), return_index=True,
                                    return_inverse=True)
    return coords[indices], indices, inverse


def augment(points: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Random z-rot + global scale + 4-way flip."""
    theta = rng.uniform(0, 2 * np.pi)
    scale = rng.uniform(0.95, 1.05)
    rot = np.array([[np.cos(theta), np.sin(theta), 0],
                    [-np.sin(theta), np.cos(theta), 0],
                    [0, 0, 1]])
    out = points.copy()
    out[:, :3] = out[:, :3] @ rot * scale
    flip = rng.choice(4)
    if flip == 1:
        out[:, 0] = -out[:, 0]
    elif flip == 2:
        out[:, 1] = -out[:, 1]
    elif flip == 3:
        out[:, :2] = -out[:, :2]
    return out


def process_scan(points: np.ndarray, labels: np.ndarray, voxel_size: float,
                 num_points: int, train: bool,
                 rng: Optional[np.random.Generator] = None) -> Dict:
    """points (N, 4) float32 [x y z intensity]; labels (N,) int remapped."""
    if train:
        points = augment(points, rng or np.random.default_rng())
    pc = np.round(points[:, :3] / voxel_size).astype(np.int32)
    pc -= pc.min(0, keepdims=True)

    coords, inds, inverse = sparse_quantize(pc)
    subsampled = train and len(inds) > num_points
    if subsampled:
        inds = (rng or np.random.default_rng()).choice(
            inds, num_points, replace=False)
        coords = pc[inds]

    # pack-key order (batch, z, y, x); voxel selection is unchanged
    perm = np.lexsort((coords[:, 0], coords[:, 1], coords[:, 2]))
    coords = coords[perm]
    inds = inds[perm]
    if not subsampled:
        rank = np.empty(len(perm), np.int32)
        rank[perm] = np.arange(len(perm), dtype=np.int32)
        inverse = rank[inverse]
    return {
        "feats": points[inds].astype(np.float32),
        "coords": coords.astype(np.int32),
        "labels": labels[inds].astype(np.int32),
        "point_labels": labels.astype(np.int32),
        "inverse_map": inverse.astype(np.int32),
    }


def label_path(scan_path: str) -> str:
    """`<seq>/velodyne/<n>.bin` -> `<seq>/labels/<n>.label`."""
    return scan_path.replace("velodyne", "labels").replace(".bin", ".label")


def dataset_root(root: str) -> str:
    """`root` when it is a directory; else raises, naming the path (the
    JAX tools fall back to synthetic scans there)."""
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"dataset.root {root!r} is not a directory: point it at the "
            "SemanticKITTI sequences (dataset.root=...) or pass --synthetic")
    return root


class SemanticKITTI:
    """The scans of one split under `root` (`<root>/<seq>/velodyne/*.bin`,
    sequences in order, files sorted, every `sample_stride`-th kept), each
    voxelized by `process_scan`; the train split augments and caps at
    `num_points` voxels. A sequence without a velodyne directory is
    skipped."""

    def __init__(self, root: str, split: str = "train",
                 voxel_size: float = 0.05, num_points: int = 80000,
                 sample_stride: int = 1):
        self.root = root
        self.split = split
        self.voxel_size = voxel_size
        self.num_points = num_points
        seqs = {"train": TRAIN_SEQS, "val": VAL_SEQS, "test": TEST_SEQS}[split]
        self.files: List[str] = []
        for seq in seqs:
            d = os.path.join(root, seq, "velodyne")
            if not os.path.isdir(d):
                continue
            self.files.extend(os.path.join(d, f) for f in sorted(os.listdir(d)))
        if sample_stride > 1:
            self.files = self.files[::sample_stride]
        self.label_map = build_label_map()

    def __len__(self):
        return len(self.files)

    def raw(self, index: int):
        """(points (N, 4) float32, labels (N,) int64) of scan `index` before
        voxelization: the label file's low 16 bits (the high 16 hold the
        instance id) through the label map; all 0 on the test split and
        for a scan without a label file."""
        points = np.fromfile(self.files[index], np.float32).reshape(-1, 4)
        lf = label_path(self.files[index])
        if self.split != "test" and os.path.exists(lf):
            labels = self.label_map[np.fromfile(lf, np.int32) & 0xFFFF]
        else:
            labels = np.zeros(len(points), np.int64)
        return points, labels

    def __getitem__(self, index: int, rng=None) -> Dict:
        points, labels = self.raw(index)
        out = process_scan(points, labels, self.voxel_size, self.num_points,
                           self.split == "train", rng)
        out["file_name"] = self.files[index]
        return out


def synthetic_scan(rng: np.random.Generator, n_points: int = 120000,
                   voxel_size: float = 0.05) -> Dict:
    """Synthetic LiDAR scan with HDL-64-like beam geometry (64 elevation
    rings x azimuth grid): downward beams hit the ground plane, a quarter of
    the rays hit vertical surfaces at sampled ranges."""
    n_az = max(64, n_points // 64)
    az = np.linspace(0, 2 * np.pi, n_az, endpoint=False)
    el = np.deg2rad(np.linspace(-24.8, 2.0, 64))
    az_g, el_g = np.meshgrid(az, el)
    az_g = (az_g + rng.normal(0, 1e-3, az_g.shape)).ravel()
    el_g = el_g.ravel()

    sensor_z = 1.73
    with np.errstate(divide="ignore"):
        r_ground = np.where(el_g < -1e-3, sensor_z / np.tan(-el_g), 120.0)
    hit_obj = rng.random(el_g.shape) < 0.25
    r_obj = np.exp(rng.uniform(np.log(2.5), np.log(60.0), el_g.shape))
    r = np.where(hit_obj, np.minimum(r_obj, r_ground), r_ground)
    r = np.clip(r + rng.normal(0, 0.02, r.shape), 2.0, 80.0)

    x = r * np.cos(el_g) * np.cos(az_g)
    y = r * np.cos(el_g) * np.sin(az_g)
    z = sensor_z + r * np.sin(el_g) - 1.73
    keep = rng.random(x.shape) < min(1.0, n_points / x.size)
    xyz = np.stack([x, y, z], 1)[keep].astype(np.float32)
    intensity = rng.uniform(0, 1, (len(xyz), 1)).astype(np.float32)
    points = np.concatenate([xyz, intensity], 1)
    labels = np.where(hit_obj[keep], rng.integers(1, 20, len(xyz)),
                      9).astype(np.int64)
    return {"points": points, "labels": labels}


class SyntheticSemanticKITTI:
    """Synthetic stand-in for SemanticKITTI; scan i is made from seed + i."""

    def __init__(self, length: int = 64, voxel_size: float = 0.05,
                 num_points: int = 80000, split: str = "train", seed: int = 0,
                 n_raw_points: int = 120000):
        self.length = length
        self.voxel_size = voxel_size
        self.num_points = num_points
        self.split = split
        self.seed = seed
        self.n_raw = n_raw_points

    def __len__(self):
        return self.length

    def __getitem__(self, index: int, rng=None) -> Dict:
        """Scan `index`; `rng` (a numpy Generator) drives the train-split
        augmentation and subsampling instead of the scan's own generator,
        as the training loop's per-step seeds do."""
        gen = np.random.default_rng(self.seed + index)
        scan = synthetic_scan(gen, self.n_raw, self.voxel_size)
        out = process_scan(scan["points"], scan["labels"], self.voxel_size,
                           self.num_points, self.split == "train",
                           rng or gen)
        out["file_name"] = f"synthetic/{index:06d}.bin"
        return out


def write_synthetic_tree(root: str, seqs: Dict[str, int],
                         n_raw_points: int = 120000,
                         seed: int = 0) -> List[str]:
    """Write synthetic scans in the dataset's layout under `root`, for runs
    without the dataset: `seqs` maps a sequence name to its number of
    scans; scan j of sequence q is `synthetic_scan` of seed + 1000 q + j.
    Each label file holds raw uint32 labels: the class's raw label (half of
    the cars as "moving-car", 252, which the learning map folds back) in
    the low 16 bits and an instance id in the high 16; a sequence of the
    test split gets no label files. Returns the `.bin` paths."""
    inverse = inverse_label_lut()
    paths = []
    for seq, n in seqs.items():
        for j in range(n):
            rng = np.random.default_rng(seed + 1000 * int(seq) + j)
            scan = synthetic_scan(rng, n_raw_points)
            path = os.path.join(root, seq, "velodyne", f"{j:06d}.bin")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            scan["points"].astype(np.float32).tofile(path)
            paths.append(path)
            if seq in TEST_SEQS:
                continue
            cls = scan["labels"]
            raw = inverse[cls]
            raw[(cls == 1) & (rng.random(len(cls)) < 0.5)] = 252
            instance = rng.integers(0, 40, len(cls)).astype(np.uint32)
            lf = label_path(path)
            os.makedirs(os.path.dirname(lf), exist_ok=True)
            (raw | (instance << np.uint32(16))).astype(np.uint32).tofile(lf)
    return paths
