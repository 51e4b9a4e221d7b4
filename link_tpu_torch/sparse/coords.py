"""Coordinate keys, sorting, dedup and joins for sparse voxel tensors.

PyTorch counterpart of `link_tpu/sparse/coords.py`. Integer voxel
coordinates `(x, y, z, b)` are linearized into an exact, order-preserving
pair of int32 keys `(hi, lo)`; deduplication is a stable sort over the
keys and a join is a lower-bound search in a sorted key table. Both are
deterministic and collision-free.

The join (`CoordTable.query`) runs through the hand-written `sorted_join`
kernel on CUDA tensors (`link_tpu_torch/ops/kernels.py`).

Bit budget: x, y in [-OFFSET, 2^14 - OFFSET), z in [-OFFSET_Z,
2^12 - OFFSET_Z), batch in [0, 2^17). Padding rows carry `INVALID_COORD`,
which packs to `(INT32_MAX, INT32_MAX)`: it sorts after every real key and
never joins.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..ops import kernels

Int3 = Tuple[int, int, int]

X_BITS = 14
Y_BITS = 14
Z_BITS = 12
OFFSET_XY = 512  # shift applied so slightly-negative probes stay packable
OFFSET_Z = 512
SPAN_X = 1 << X_BITS
SPAN_Y = 1 << Y_BITS
SPAN_Z = 1 << Z_BITS

INT32_MAX = 2**31 - 1
# Sentinel coordinate value marking padding rows (never packs to a valid key).
INVALID_COORD = -(2**20)


def make_ntuple(x: Union[int, Sequence[int]], ndim: int = 3) -> Tuple[int, ...]:
    if isinstance(x, (list, tuple, np.ndarray)):
        assert len(x) == ndim
        return tuple(int(v) for v in x)
    return (int(x),) * ndim


def pack_coords(coords: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack (N, 4) int32 (x, y, z, b) coords into an order-preserving int32
    key pair (hi, lo). Out-of-range / sentinel coords map to (INT32_MAX,
    INT32_MAX). Sort order of (hi, lo) is lexicographic (b, z, y, x)."""
    x = coords[:, 0] + OFFSET_XY
    y = coords[:, 1] + OFFSET_XY
    z = coords[:, 2] + OFFSET_Z
    b = coords[:, 3]
    valid = ((x >= 0) & (x < SPAN_X) & (y >= 0) & (y < SPAN_Y)
             & (z >= 0) & (z < SPAN_Z) & (b >= 0))
    hi = (b << Z_BITS) | (z & (SPAN_Z - 1))
    lo = (y << X_BITS) | (x & (SPAN_X - 1))
    sent = torch.full_like(hi, INT32_MAX)
    hi = torch.where(valid, hi, sent).to(torch.int32)
    lo = torch.where(valid, lo, sent).to(torch.int32)
    return hi, lo


def key_is_valid(hi: torch.Tensor) -> torch.Tensor:
    return hi != INT32_MAX


def sort_by_key(hi: torch.Tensor, lo: torch.Tensor, *payloads: torch.Tensor):
    """Stable lexicographic sort by (hi, lo); payloads carried along."""
    order = torch.sort(kernels.key64(hi, lo), stable=True).indices
    return (hi[order], lo[order]) + tuple(p[order] for p in payloads)


@dataclass
class CoordTable:
    """Sorted key table over a coordinate set, for repeated joins.

    `hi`, `lo` are the sorted keys and `perm[p]` the original row of sorted
    position p. Cached on `SparseTensor.kmaps` and shared by every plan built
    at the same coordinate map."""

    hi: torch.Tensor      # (N,) int32
    lo: torch.Tensor      # (N,) int32
    perm: torch.Tensor    # (N,) int32

    def query(self, coords: torch.Tensor) -> torch.Tensor:
        """Index of each query coord (..., 4) in the original coordinate
        rows, or -1 when absent. One `sorted_join` launch per call."""
        shape = coords.shape[:-1]
        q_hi, q_lo = pack_coords(coords.reshape(-1, coords.shape[-1]))
        return kernels.sorted_join(self.hi, self.lo, self.perm,
                                   q_hi, q_lo).reshape(shape)


def build_table(coords: torch.Tensor, assume_sorted: bool = False) -> CoordTable:
    """`assume_sorted=True` skips the sort (perm = identity) for coords
    already in pack-key order, the invariant that collate, unique_coords
    and spdownsample maintain."""
    hi, lo = pack_coords(coords)
    perm = torch.arange(coords.shape[0], dtype=torch.int32,
                        device=coords.device)
    if not assume_sorted:
        hi, lo, perm = sort_by_key(hi, lo, perm)
    return CoordTable(hi.contiguous(), lo.contiguous(), perm.contiguous())


def unique_coords(coords: torch.Tensor, out_capacity: int):
    """Deduplicate coordinate rows into a fixed-capacity output.

    Returns (out_coords, inverse, out_nnz):
      * out_coords: (out_capacity, 4) int32, unique coords in (b, z, y, x)
        key order, padded with INVALID_COORD;
      * inverse:    (N,) int32, for each input row the slot of its unique
        coord, or -1 for padding/overflowed rows;
      * out_nnz:    () int32, number of unique coords (clamped).
    """
    n = coords.shape[0]
    dev = coords.device
    hi, lo = pack_coords(coords)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    s_hi, s_lo, s_idx = sort_by_key(hi, lo, idx)

    first = torch.full((1,), -1, dtype=torch.int32, device=dev)
    prev_hi = torch.cat([first, s_hi[:-1]])
    prev_lo = torch.cat([first, s_lo[:-1]])
    valid = key_is_valid(s_hi)
    is_new = ((s_hi != prev_hi) | (s_lo != prev_lo)) & valid

    slot = torch.cumsum(is_new.to(torch.int64), 0) - 1
    out_nnz = torch.clamp(is_new.sum(), max=out_capacity).to(torch.int32)

    in_range = valid & (slot < out_capacity)
    dump = torch.full_like(slot, out_capacity)
    write_slot = torch.where(is_new & in_range, slot, dump)
    out_coords = torch.full((out_capacity + 1, 4), INVALID_COORD,
                            dtype=torch.int32, device=dev)
    # every in-range slot is written by exactly one row; the dump row takes
    # the rest and is cut off
    out_coords[write_slot] = coords[s_idx]
    out_coords = out_coords[:out_capacity]

    inv_vals = torch.where(in_range, slot, torch.full_like(slot, -1))
    inverse = torch.empty(n, dtype=torch.int32, device=dev)
    inverse[s_idx] = inv_vals.to(torch.int32)
    return out_coords, inverse, out_nnz


@functools.lru_cache(maxsize=None)
def _kernel_offsets(size: Int3, stride: Int3, dilation: Int3) -> np.ndarray:
    axes = [np.arange(-size[k] // 2 + 1, size[k] // 2 + 1)
            * stride[k] * dilation[k] for k in range(3)]
    if int(np.prod(size)) % 2 == 1:
        offs = [[x, y, z] for z in axes[2] for y in axes[1] for x in axes[0]]
    else:
        offs = [[x, y, z] for x in axes[0] for y in axes[1] for z in axes[2]]
    out = np.asarray(offs, dtype=np.int32)
    out.setflags(write=False)
    return out


def kernel_offsets_np(size: Union[int, Int3], stride: Union[int, Int3] = 1,
                      dilation: Union[int, Int3] = 1) -> np.ndarray:
    """Enumerate kernel tap offsets in the reference's weight layout
    (torchsparse nn/utils/kernel.py:11-32): odd kernel volumes are z-major,
    even ones x-major."""
    return _kernel_offsets(make_ntuple(size), make_ntuple(stride),
                           make_ntuple(dilation))
