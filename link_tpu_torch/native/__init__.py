"""Native (C++) host kernels of the det serving path, loaded over ctypes.

The port's copy of `link_tpu/native`: `nms.cpp` (rotated BEV overlap by
Sutherland-Hodgman clipping in double precision, greedy rotated NMS, BEV and
3D IoU matrices) and `voxelize.cpp` (hash-grid hard voxelization emitting
rows in pack-key (z, y, x) order), with the same C ABI.

The library is built at first use, not at import, with
`g++ -O3 -shared -fPIC -std=c++17` into `link_tpu_torch/_build/`, under a
name that hashes the sources and the flags. Each build writes a temporary
file and renames it into place, so that processes building at the same time
do not see a partial library. A missing compiler or a failed build raises
with the compiler's output: no caller falls back to the NumPy twins unless
it asks for them.

ctypes releases the GIL for the length of a call, so calls may run in
several threads at once: the voxelizer's scratch is thread_local, and every
array a call reads or writes stays referenced by the Python frame until it
returns.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..sparse.coords import INVALID_COORD

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
SOURCES = ("nms.cpp", "voxelize.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# the host implementations a caller of `points_to_voxel` or
# `rotate_nms_pcdet` chooses between: this library, or the NumPy twin
IMPLS = ("native", "numpy")

_LIB: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")


def so_path() -> Path:
    """The library's path: a hash of the sources and the flags."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.encode() + b"\0" + (SRC_DIR / src).read_bytes())
    return BUILD_DIR / f"libnative-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless an up-to-date one exists; returns its
    path. Raises RuntimeError without g++ or when g++ fails."""
    so = so_path()
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the port's native host "
                           "kernels (link_tpu_torch/native) need it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    out = subprocess.run(
        [cxx, *CXX_FLAGS, *(str(SRC_DIR / s) for s in SOURCES), "-o",
         str(tmp)], capture_output=True, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed building {so.name}:\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, so)
    return so


def _lib() -> ctypes.CDLL:
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        f32 = ctypes.POINTER(ctypes.c_float)
        i32 = ctypes.POINTER(ctypes.c_int32)
        i64 = ctypes.c_int64
        lib.rotate_nms.restype = i64
        lib.rotate_nms.argtypes = [f32, i64, ctypes.c_float, i64,
                                   ctypes.POINTER(i64)]
        lib.bev_iou_matrix.restype = None
        lib.bev_iou_matrix.argtypes = [f32, i64, f32, i64, f32]
        lib.iou3d_matrix.restype = None
        lib.iou3d_matrix.argtypes = lib.bev_iou_matrix.argtypes
        lib.voxelize.restype = i64
        lib.voxelize.argtypes = [f32, i64, i64, f32, f32, i32, i64, i64,
                                 f32, i32, i32, i64, i64]
        _LIB = lib
        return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def rotate_nms_sorted(boxes: np.ndarray, thresh: float,
                      post_max: int = 0) -> np.ndarray:
    """boxes (N, 7) float32 [x y z w l h r], already sorted by score,
    descending. Returns the kept row indices (at most post_max when it is
    > 0)."""
    lib = _lib()
    boxes = np.ascontiguousarray(boxes, np.float32)
    keep = np.empty(len(boxes), np.int64)
    n = lib.rotate_nms(_fptr(boxes), len(boxes), ctypes.c_float(thresh),
                       post_max or 0,
                       keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return keep[:n]


def _voxelize(points, voxel_size, pc_range, grid, max_points, max_voxels,
              voxels, coords, nppv, coord_mode, batch_idx) -> int:
    lib = _lib()
    pts = np.ascontiguousarray(points, np.float32)
    vs = np.ascontiguousarray(voxel_size, np.float32)
    pr = np.ascontiguousarray(pc_range, np.float32)
    gr = np.ascontiguousarray(grid, np.int32)
    n, f = pts.shape
    return lib.voxelize(_fptr(pts), n, f, _fptr(vs), _fptr(pr), _iptr(gr),
                        max_points, max_voxels, _fptr(voxels), _iptr(coords),
                        _iptr(nppv), coord_mode, batch_idx)


def voxelize_points(points: np.ndarray, voxel_size, pc_range, grid,
                    max_points: int, max_voxels: int):
    """Hard voxelization (voxelize.cpp): (voxels (V, max_points, F),
    coords (V, 3) (z, y, x), nppv (V,)) in pack-key row order; the first
    max_voxels voxels and the first max_points points of each, by
    appearance. The output pages are zeroed per call: the kernel writes
    only the bytes that carry points."""
    f = points.shape[1]
    voxels = np.zeros((max_voxels, max_points, f), np.float32)
    coords = np.empty((max_voxels, 3), np.int32)
    nppv = np.zeros((max_voxels,), np.int32)
    nv = _voxelize(points, voxel_size, pc_range, grid, max_points,
                   max_voxels, voxels, coords, nppv, 0, 0)
    return voxels[:nv], coords[:nv], nppv[:nv]


def voxelize_collated(points: np.ndarray, voxel_size, pc_range, grid,
                      max_points: int, max_voxels: int, capacity: int,
                      num_feats: int = 5, batch_idx: int = 0):
    """Voxelize and collate one frame in one native pass: the batch dict of
    `data.det_pipeline.collate_det` (voxels (capacity, max_points, F)
    zero-padded, coords (capacity, 4) (x, y, z, b) with INVALID_COORD pad
    rows, num_points, nnz)."""
    if capacity < max_voxels:
        raise ValueError(f"capacity {capacity} < max_voxels {max_voxels}")
    if points.shape[1] != num_feats:
        raise ValueError(f"points have {points.shape[1]} features, "
                         f"expected {num_feats}")
    voxels = np.zeros((capacity, max_points, num_feats), np.float32)
    coords = np.full((capacity, 4), INVALID_COORD, np.int32)
    nppv = np.zeros((capacity,), np.int32)
    nv = _voxelize(points, voxel_size, pc_range, grid, max_points,
                   max_voxels, voxels, coords, nppv, 1, batch_idx)
    return {"voxels": voxels, "coords": coords, "num_points": nppv,
            "nnz": np.int32(nv)}


def _pair_matrix(fn_name: str, boxes_a: np.ndarray,
                 boxes_b: np.ndarray) -> np.ndarray:
    lib = _lib()
    a = np.ascontiguousarray(boxes_a, np.float32)
    b = np.ascontiguousarray(boxes_b, np.float32)
    out = np.empty((len(a), len(b)), np.float32)
    getattr(lib, fn_name)(_fptr(a), len(a), _fptr(b), len(b), _fptr(out))
    return out


def bev_iou(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(Na, Nb) BEV rotated IoU of (N, 7) boxes."""
    return _pair_matrix("bev_iou_matrix", boxes_a, boxes_b)


def iou3d(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(Na, Nb) 3D IoU (BEV overlap times the z-extent overlap)."""
    return _pair_matrix("iou3d_matrix", boxes_a, boxes_b)
