"""Point <-> voxel transforms of the point-voxel model (SPVCNN).

PyTorch counterpart of `link_tpu/ops/point.py` (reference:
segmentation/core/models/utils.py:234-323 and torchsparse's trilinear
`calc_ti_weights`, nn/functional/devoxelize.py:11-48).

A PointTensor carries float coords (x, y, z, batch); a voxel join floors
the coords by the tensor stride, in plain PyTorch inside
`coords.JOIN_INPUT_RANGE`. Every join is then one `sorted_join` launch
inside `coords.JOIN_RANGE`: `point_to_voxel` queries the level's table once
per point, `voxel_to_point` joins the 8 floor corners of every point in one
`join_taps` call. The joins' indices and weights are cached on the
PointTensor per stride (the reference's `additional_features['idx_query']`)
in a dict shared by every PointTensor derived from it, so a later transform
at the same stride reuses them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch

from ..sparse import coords as coordlib
from ..sparse import ops as spops
from ..sparse.tensor import SparseTensor
from ..utils.profiling import span


@dataclass
class PointTensor:
    feats: torch.Tensor       # (Np, C)
    coords: torch.Tensor      # (Np, 4) float32, batch in the last column
    nnz: torch.Tensor         # () int32
    caches: Dict = field(default_factory=dict)

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.coords.shape[0],
                            device=self.coords.device) < self.nnz

    def replace(self, **kw) -> "PointTensor":
        """Shallow copy with fields replaced; `caches` stays shared."""
        return dataclasses.replace(self, **kw)


def make_point_tensor(feats, coords, nnz=None) -> PointTensor:
    coords = torch.as_tensor(coords).to(torch.float32)
    n = coords.shape[0]
    nnz = torch.as_tensor(n if nnz is None else nnz).to(
        device=coords.device, dtype=torch.int32)
    return PointTensor(feats=torch.as_tensor(feats), coords=coords, nnz=nnz)


def _sentinel_rows(pt: PointTensor, c: torch.Tensor) -> torch.Tensor:
    """c with the rows of padding points set to INVALID_COORD."""
    return torch.where(pt.valid_mask()[:, None], c,
                       torch.full_like(c, coordlib.INVALID_COORD))


def _int_coords(pt: PointTensor) -> torch.Tensor:
    """Floor float point coords to int voxel coords, keeping padding rows
    sentinel."""
    xyz = torch.floor(pt.coords[:, :3]).to(torch.int32)
    b = pt.coords[:, 3:].to(torch.int32)
    return _sentinel_rows(pt, torch.cat([xyz, b], dim=1))


def _floor_base(pt: PointTensor, s: int) -> torch.Tensor:
    """(Np, 4) int32 rows floor(p / s) * s with the batch column; padding
    points sentinel. Formed inside `coords.JOIN_INPUT_RANGE`."""
    with span(coordlib.JOIN_INPUT_RANGE):
        xyz = (torch.floor(pt.coords[:, :3] / s) * s).to(torch.int32)
        return _sentinel_rows(
            pt, torch.cat([xyz, pt.coords[:, 3:].to(torch.int32)], dim=1))


def _level_table(st: SparseTensor) -> coordlib.CoordTable:
    return coordlib.build_table(st.coords, assume_sorted=st.coords_sorted)


def initial_voxelize(pt: PointTensor, init_res: float, after_res: float,
                     capacity: int) -> Tuple[SparseTensor, torch.Tensor]:
    """utils.py:234-254: rescale the float coords, floor, dedup, mean-pool.
    Returns (voxel tensor, idx_query) and caches idx / counts at stride 1."""
    scaled = torch.cat([pt.coords[:, :3] * (init_res / after_res),
                        pt.coords[:, 3:]], dim=1)
    ic = _int_coords(pt.replace(coords=scaled))
    out_coords, idx_query, out_nnz = coordlib.unique_coords(ic, capacity)
    counts = spops.spcount(idx_query, capacity)
    feats = spops.spvoxelize(pt.feats, idx_query, counts)
    st = SparseTensor(feats=feats, coords=out_coords, nnz=out_nnz,
                      stride=(1, 1, 1), base_sorted=True, coords_sorted=True)
    st.cmaps[st.stride] = (out_coords, out_nnz)
    pt.caches[("idx", (1, 1, 1))] = idx_query
    pt.caches[("counts", (1, 1, 1))] = counts
    return st, idx_query


def point_to_voxel(st: SparseTensor, pt: PointTensor) -> SparseTensor:
    """utils.py:259-282: mean-pool the point feats onto st's coords."""
    key = ("idx", st.stride)
    if key in pt.caches:
        idx_query = pt.caches[key]
        counts = pt.caches[("counts", st.stride)]
    else:
        idx_query = _level_table(st).query(_floor_base(pt, st.stride[0]))
        counts = spops.spcount(idx_query, st.capacity)
        pt.caches[key] = idx_query
        pt.caches[("counts", st.stride)] = counts
    return st.replace(feats=spops.spvoxelize(pt.feats, idx_query, counts))


def calc_ti_weights(pc: torch.Tensor, idx_query: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Trilinear weights over the 8 floor-corner voxels, in the corner
    order of `kernel_offsets_np((2, 2, 2))` (devoxelize.py:11-48). pc (Np,
    3) float32, idx_query (Np, 8); misses weigh 0 and each row is
    renormalised, in the JAX package's order of operations."""
    p = pc
    pf = torch.floor(pc / scale) * scale if scale != 1 else torch.floor(pc)
    pcn = pf + scale
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    xf, yf, zf = pf[:, 0], pf[:, 1], pf[:, 2]
    xc, yc, zc = pcn[:, 0], pcn[:, 1], pcn[:, 2]
    w = torch.stack([
        (xc - x) * (yc - y) * (zc - z),
        (xc - x) * (yc - y) * (z - zf),
        (xc - x) * (y - yf) * (zc - z),
        (xc - x) * (y - yf) * (z - zf),
        (x - xf) * (yc - y) * (zc - z),
        (x - xf) * (yc - y) * (z - zf),
        (x - xf) * (y - yf) * (zc - z),
        (x - xf) * (y - yf) * (z - zf),
    ], dim=1)
    if scale != 1:
        w = w / scale ** 3
    w = torch.where(idx_query >= 0, w, torch.zeros_like(w))
    return w / (w.sum(dim=1, keepdim=True) + 1e-8)


def voxel_to_point(st: SparseTensor, pt: PointTensor,
                   nearest: bool = False) -> PointTensor:
    """utils.py:287-323: trilinear (or nearest) interpolation of the voxel
    feats at the float point positions."""
    key = ("v2p_idx", st.stride)
    if key in pt.caches:
        idx_query = pt.caches[key]
        weights = pt.caches[("v2p_w", st.stride)]
    else:
        s = st.stride[0]
        offs = coordlib.kernel_offsets_np((2, 2, 2), stride=st.stride)
        idx_query = coordlib.join_taps(_level_table(st), _floor_base(pt, s),
                                       offs).T                  # (Np, 8)
        weights = calc_ti_weights(pt.coords[:, :3], idx_query, float(s))
        if nearest:
            weights = torch.cat([weights[:, :1],
                                 torch.zeros_like(weights[:, 1:])], dim=1)
            idx_query = torch.cat([idx_query[:, :1],
                                   torch.full_like(idx_query[:, 1:], -1)],
                                  dim=1)
        pt.caches[key] = idx_query
        pt.caches[("v2p_w", st.stride)] = weights
    return pt.replace(feats=spops.spdevoxelize(st.feats, idx_query, weights))
