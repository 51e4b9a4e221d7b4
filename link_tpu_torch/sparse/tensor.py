"""Fixed-capacity sparse voxel tensor.

PyTorch counterpart of `link_tpu/sparse/tensor.py`. `feats` / `coords` have
a fixed row capacity; `nnz` (a 0-d int32 tensor on the same device) counts
the valid rows. Padding rows carry `INVALID_COORD` coords and arbitrary
feats; every aggregation masks them through the key sentinel.

`cmaps` (stride -> (coords, nnz)) and `kmaps` (kernel-map and key-table
cache) are dicts shared by every tensor derived from one input, as in the
JAX package and torchsparse.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from . import coords as coordlib


@dataclass
class ConvPlan:
    """Kernel map for one (in_stride, kernel_size, stride, dilation) combo.

    `in_idx[k, j]` is the input row feeding output row `j` through tap `k`,
    or -1 on a miss. `inv_idx[k, i]` (built by `conv.invert_plan`) is the
    output row j with in_idx[k, j] == i, or -1: the transposed conv runs as a
    gather over it. `mirror` is the tap permutation with offsets[mirror[k]]
    == -offsets[k], set for submanifold plans. `bwd_idx` caches the inverse
    map the conv's backward gathers over (`conv.plan_bwd_idx`: the mirrored
    taps of a submanifold plan, else `inv_idx`), filled at first use;
    `bwd_work` and `in_work` the weight-gradient work lists
    (`kernels.wgrad_work_list`) of `bwd_idx` and of `in_idx` (the
    transposed conv's inverse map), filled at first use likewise.

    When the input rows are in pack-key order the plan also carries the
    window form (link_tpu/sparse/tensor.py:29-88): taps grouped by (dy, dz)
    hit consecutive table rows from `base_pos[g, j]`, and `slot[k, j]` is
    tap k's row relative to its group's base (-1 on a miss). `groups` is
    the static tuple of tap ids per group and `self_group` the index of the
    (dy, dz) == (0, 0) group of a submanifold plan."""

    in_idx: torch.Tensor          # (K, M_out) int32
    out_coords: torch.Tensor      # (M_out, 4) int32
    out_nnz: torch.Tensor         # () int32
    in_capacity: int
    inv_idx: Optional[torch.Tensor] = None   # (K, N_in) int32
    mirror: Optional[Tuple[int, ...]] = None
    base_pos: Optional[torch.Tensor] = None  # (Gg, M_out) int32
    slot: Optional[torch.Tensor] = None      # (K, M_out) int8
    groups: Optional[Tuple[Tuple[int, ...], ...]] = None
    self_group: Optional[int] = None
    bwd_idx: Optional[torch.Tensor] = None   # (K, N_in) int32
    bwd_work: Optional[Any] = None           # kernels.WgradWork of bwd_idx
    in_work: Optional[Any] = None            # kernels.WgradWork of in_idx

    @property
    def window(self) -> int:
        """Window width G (the longest group), 0 without groups."""
        return max(len(t) for t in self.groups) if self.groups else 0

    def replace(self, **kw) -> "ConvPlan":
        return dataclasses.replace(self, **kw)


@dataclass
class SparseTensor:
    feats: torch.Tensor                     # (N, C)
    coords: torch.Tensor                    # (N, 4) int32 (x, y, z, batch)
    nnz: torch.Tensor                       # () int32
    stride: Tuple[int, int, int] = (1, 1, 1)
    cmaps: Dict[Tuple[int, ...], Any] = field(default_factory=dict)
    kmaps: Dict[Tuple[Any, ...], Any] = field(default_factory=dict)
    # whether the creation-time coords were in pack-key order (b, z, y, x)
    base_sorted: bool = False
    # whether THIS tensor's coords are in pack-key order
    coords_sorted: bool = False
    # optional static (nx, ny, nz, nb) bound on the stride-1 coord domain
    grid_extent: Optional[Tuple[int, int, int, int]] = None

    @property
    def capacity(self) -> int:
        return self.feats.shape[0]

    @property
    def device(self) -> torch.device:
        return self.feats.device

    def valid_mask(self) -> torch.Tensor:
        """(N,) bool: which rows are real voxels, from the coords."""
        hi, _ = coordlib.pack_coords(self.coords)
        return coordlib.key_is_valid(hi)

    def replace(self, **kw) -> "SparseTensor":
        """Shallow copy with fields replaced; cmaps/kmaps stay shared."""
        return dataclasses.replace(self, **kw)


def make_sparse_tensor(feats, coords, nnz=None, stride=1,
                       base_sorted: bool = False, grid_extent=None,
                       device="cuda") -> SparseTensor:
    """Build a SparseTensor from arrays or tensors on `device`.

    `nnz` forces rows at or past it to the sentinel so joins skip them.
    `base_sorted=True` asserts the valid coords are in pack-key order (as
    the collate functions emit them). `grid_extent=(nx, ny, nz, nb)` asserts
    every valid coord lies in [0, extent)."""
    stride = coordlib.make_ntuple(stride)
    coords = torch.as_tensor(coords).to(device=device, dtype=torch.int32)
    feats = torch.as_tensor(feats).to(device=device)
    n = coords.shape[0]
    if nnz is None:
        nnz = torch.tensor(n, dtype=torch.int32, device=device)
    else:
        nnz = torch.as_tensor(nnz).to(device=device, dtype=torch.int32)
        row = torch.arange(n, dtype=torch.int32, device=device)
        coords = torch.where((row < nnz)[:, None], coords,
                             torch.full_like(coords, coordlib.INVALID_COORD))
    if grid_extent is not None:
        grid_extent = tuple(int(v) for v in grid_extent)
    st = SparseTensor(feats=feats, coords=coords, nnz=nnz, stride=stride,
                      base_sorted=base_sorted, coords_sorted=base_sorted,
                      grid_extent=grid_extent)
    st.cmaps[stride] = (coords, nnz)
    return st


def cat(tensors) -> SparseTensor:
    """Channel-wise concat of SparseTensors sharing coords."""
    first = tensors[0]
    return first.replace(feats=torch.cat([t.feats for t in tensors], dim=1))
