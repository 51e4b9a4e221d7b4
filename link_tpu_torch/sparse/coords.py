"""Coordinate keys, sorting, dedup and joins for sparse voxel tensors.

PyTorch counterpart of `link_tpu/sparse/coords.py`. Integer voxel
coordinates `(x, y, z, b)` are linearized into an exact, order-preserving
pair of int32 keys `(hi, lo)`; deduplication is a stable sort over the
keys and a join is a lower-bound search in a sorted key table. Both are
deterministic and collision-free.

The joins (`CoordTable.query`, `join_taps`, and `window_join`, which adds
the window form's base rows and slots) run through the hand-written
`sorted_join` kernel on CUDA tensors, which forms the queries from the base
rows and the tap offsets itself (`link_tpu_torch/ops/kernels.py`); each
join site is one call inside the profiler range `JOIN_RANGE`.

Bit budget: x, y in [-OFFSET, 2^14 - OFFSET), z in [-OFFSET_Z,
2^12 - OFFSET_Z), batch in [0, 2^17). Padding rows carry `INVALID_COORD`,
which packs to `(INT32_MAX, INT32_MAX)`: it sorts after every real key and
never joins.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops import kernels
from ..ops.kernels import INT32_MAX, offset_groups, pack_coords
from ..utils.profiling import span

Int3 = Tuple[int, int, int]

# Sentinel coordinate value marking padding rows (never packs to a valid key).
INVALID_COORD = -(2**20)
# profiler range around every join site: forming the queries, the join,
# and the window form's pinning and slots (read by chip_smoke.py and
# link_tpu_torch/tools/join_sites.py)
JOIN_RANGE = "sparse/join_site"
# profiler range around the PyTorch operations that form a join's inputs
# outside the kernel, where the kernel cannot form them from base rows and
# offsets: the floored base rows of the point joins (ops/point.py) and both
# coord sets divided by upsample_voxel's stride (ops/elk.py). A join site
# there is this range and the JOIN_RANGE after it (read by chip_smoke.py)
JOIN_INPUT_RANGE = "sparse/join_inputs"


def make_ntuple(x: Union[int, Sequence[int]], ndim: int = 3) -> Tuple[int, ...]:
    if isinstance(x, (list, tuple, np.ndarray)):
        assert len(x) == ndim
        return tuple(int(v) for v in x)
    return (int(x),) * ndim


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
    at the same coordinate map. `grid` is the raw (nx, ny, nz, nb) extent of
    the level's lattice where `link_tpu` builds its dense RankGrid index
    (`build_table(grid_shape=...)`); the port builds no such index, but the
    ELK block reads the extent to take its dense aux path, as `link_tpu`
    does (ops/elk.py:aux_grid_shape)."""

    hi: torch.Tensor      # (N,) int32
    lo: torch.Tensor      # (N,) int32
    perm: torch.Tensor    # (N,) int32
    grid: Optional[Tuple[int, int, int, int]] = None

    def query(self, coords: torch.Tensor) -> torch.Tensor:
        """Index of each query coord (..., 4) in the original coordinate
        rows, or -1 when absent: the join with one zero offset, one
        `sorted_join` launch."""
        with span(JOIN_RANGE):
            return kernels.sorted_join(self.hi, self.lo, self.perm, coords)


# `link_tpu` builds the dense RankGrid join index for lattices up to this
# many cells (link_tpu/sparse/coords.py:620); the port records the extent of
# such levels on the table (CoordTable.grid) and builds no index
RANK_GRID_MAX_CELLS = 96_000_000


def build_table(coords: torch.Tensor, assume_sorted: bool = False,
                grid_shape=None, grid_quantum: int = 1) -> CoordTable:
    """`assume_sorted=True` skips the sort (perm = identity) for coords
    already in pack-key order, the invariant that collate, unique_coords
    and spdownsample maintain. `grid_shape=(nx, ny, nz, nb)` (raw extents)
    marks the table with its lattice extent when the lattice at
    `grid_quantum` fits RANK_GRID_MAX_CELLS, as `link_tpu` decides where to
    build its RankGrid."""
    hi, lo = pack_coords(coords)
    perm = torch.arange(coords.shape[0], dtype=torch.int32,
                        device=coords.device)
    if not assume_sorted:
        hi, lo, perm = sort_by_key(hi, lo, perm)
    grid = None
    if grid_shape is not None:
        q = int(grid_quantum)
        lat = [-(-int(v) // q) for v in grid_shape[:3]]
        if int(np.prod(lat)) * int(grid_shape[3]) <= RANK_GRID_MAX_CELLS:
            grid = tuple(v * q for v in lat) + (int(grid_shape[3]),)
    return CoordTable(hi.contiguous(), lo.contiguous(), perm.contiguous(),
                      grid=grid)


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


def can_group_offsets(offsets: np.ndarray, quantum: int) -> bool:
    """True when every (dy, dz) tap group's x-offsets form an arithmetic
    run with step == quantum (the window_join precondition)."""
    for _, taps in offset_groups(offsets):
        xs = [ox for ox, _ in taps]
        if any(b - a != quantum for a, b in zip(xs, xs[1:])):
            return False
    return True


def join_taps(table: CoordTable, base_coords: torch.Tensor,
              offsets: np.ndarray, mult=None) -> torch.Tensor:
    """Kernel map in_idx[k, j]: the original row of base_coords[j] (xyz
    times `mult` where given) + offsets[k], or -1. One exact `sorted_join`
    launch over all K * M queries, formed in the kernel."""
    with span(JOIN_RANGE):
        return kernels.sorted_join(table.hi, table.lo, table.perm,
                                   base_coords, offsets, mult)


def window_join(table: CoordTable, base_coords: torch.Tensor,
                offsets: np.ndarray):
    """The kernel map with its window form, over a table whose perm is the
    identity (rows in pack-key order): in_idx, base_pos, slot of
    `link_tpu/sparse/coords.py:grouped_window_query`, in one `sorted_join`
    call in mode "window" (the join and the padding anchors' pinning).

    Taps sharing (dy, dz) form x-runs with the step of the table's x
    lattice (`can_group_offsets`). Keys sort with x fastest, so a group's
    hits occupy the G table rows from the lower bound of its run's
    smallest x: base_pos is that lower bound and a hit's slot is its row
    minus its group's base.

    Returns in_idx (K, M) int32; base_pos (Gg, M) int32, clamped to N - 1,
    with padding queries pinned to the group's last valid base
    (link_tpu/sparse/coords.py:1089-1096); slot (K, M) int8, -1 on a
    miss."""
    with span(JOIN_RANGE):
        return kernels.sorted_join(table.hi, table.lo, table.perm,
                                   base_coords, offsets, mode="window")
