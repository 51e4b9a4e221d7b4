"""spconv-semantics sparse convolution (detection backbone).

PyTorch counterpart of `link_tpu/sparse/spconv_engine.py`. spconv levels
store per-level grid indices, not multiples of the cumulative stride, so
every level keeps `SparseTensor.stride == (1, 1, 1)`. A strided
SparseConv3d(k, s, p) emits every output cell j whose kernel window
touches an input: i + p - j * s in [0, k) per axis, with j inside the
output shape floor((in + 2p - k) / s) + 1. Taps enumerate t in [0, k)^3
x-major with z fastest; the input feeding output j through tap t is
i = j * s - p + t.
"""

from __future__ import annotations

from itertools import product
from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import coords as coordlib
from .conv import apply_conv_plan
from ..utils.profiling import PLAN, span
from .tensor import ConvPlan, SparseTensor


def spconv_out_shape(in_shape, kernel_size, stride, padding):
    return tuple((in_shape[a] + 2 * padding[a] - kernel_size[a]) // stride[a] + 1
                 for a in range(3))


def ensure_level_table(st: SparseTensor, in_shape, batch_size: int) -> None:
    """Seed the level's shared key table before any conv builds it, marked
    with the level's (x, y, z, batch) extent where `link_tpu` would build
    its RankGrid index there (`coords.build_table`); the ELK block's dense
    aux path reads that extent."""
    tkey = ("table", st.stride)
    if tkey not in st.kmaps:
        gs = (int(in_shape[0]), int(in_shape[1]), int(in_shape[2]),
              int(batch_size))
        with span(PLAN):
            st.kmaps[tkey] = coordlib.build_table(
                st.coords, assume_sorted=st.coords_sorted, grid_shape=gs)


def _tap_offsets(kernel_size) -> np.ndarray:
    """(K, 3) tap indices t, x-major with z fastest."""
    return np.asarray(list(product(range(kernel_size[0]),
                                   range(kernel_size[1]),
                                   range(kernel_size[2]))), np.int32)


def spconv_downsample(coords: torch.Tensor, kernel_size, stride, padding,
                      out_shape, out_capacity: int,
                      dropped: Optional[torch.Tensor] = None):
    """The spconv output coordinate set: every j reachable from an input
    voxel through some tap, inside out_shape. Returns (out_coords,
    out_nnz), rows in pack-key (b, z, y, x) order, the first
    `out_capacity` of them kept: the set, order and count of
    `link_tpu`'s `_pool_downsample`. The rows past `out_capacity` are
    added to the device counter `dropped`, when given.

    Formulation: each input reaches at most ceil(k / s) outputs per axis
    (2^3 = 8 candidates for k3 s2), so the candidates are enumerated per
    input and deduplicated with `unique_coords` (one sort)."""
    ks = np.asarray(kernel_size)
    st = np.asarray(stride)
    dev = coords.device
    s = torch.tensor(stride, dtype=torch.int32, device=dev)
    p = torch.tensor(padding, dtype=torch.int32, device=dev)
    k = torch.tensor(kernel_size, dtype=torch.int32, device=dev)
    out_sh = torch.tensor(out_shape, dtype=torch.int32, device=dev)
    xyz = coords[:, :3]
    pad_row = (xyz[:, :1] <= coordlib.INVALID_COORD)
    base = torch.div(xyz + p, s, rounding_mode="floor")     # largest j
    n_per = [int((ks[a] - 1) // st[a]) + 1 for a in range(3)]
    cands = []
    for d in product(*(range(v) for v in n_per)):
        j = base - torch.tensor(d, dtype=torch.int32, device=dev)
        t = xyz + p - j * s                                   # tap index
        ok = ((t >= 0) & (t < k) & (j >= 0) & (j < out_sh)).all(
            dim=1, keepdim=True) & ~pad_row
        inv = torch.full_like(coords, coordlib.INVALID_COORD)
        cands.append(torch.where(ok, torch.cat([j, coords[:, 3:]], 1), inv))
    out_coords, _, out_nnz = coordlib.unique_coords(torch.cat(cands),
                                                    out_capacity,
                                                    dropped=dropped)
    return out_coords, out_nnz


def build_spconv_plan(in_coords: torch.Tensor, out_coords: torch.Tensor,
                      out_nnz, kernel_size, stride, padding,
                      in_capacity: int, in_sorted: bool = False,
                      table=None) -> ConvPlan:
    """Kernel map: the input for output j through tap t is i = j*s - p + t,
    one join of the base coords j * s over the offsets t - p
    (link_tpu/sparse/spconv_engine.py:243-315), the multiplier s applied in
    the kernel. The plan has no mirror, so it never takes the window
    form."""
    taps = _tap_offsets(kernel_size)
    p = np.asarray(padding, np.int32)
    if table is None:
        table = coordlib.build_table(in_coords, assume_sorted=in_sorted)
    in_idx = coordlib.join_taps(table, out_coords, taps - p[None, :],
                                mult=tuple(int(v) for v in stride))
    return ConvPlan(in_idx=in_idx, out_coords=out_coords, out_nnz=out_nnz,
                    in_capacity=in_capacity)


def spconv3d(x: SparseTensor, weight: torch.Tensor,
             kernel_size: Union[int, Tuple[int, ...]],
             in_shape: Tuple[int, int, int],
             stride: Union[int, Tuple[int, ...]] = 1,
             padding: Union[int, Tuple[int, ...]] = 0,
             out_capacity: Optional[int] = None,
             batch_size: Optional[int] = None,
             dropped: Optional[torch.Tensor] = None):
    """Strided spconv conv. `in_shape` / the returned out_shape are the
    level grids' (x, y, z) extents. Weight (K, Ci, Co) with taps in
    `_tap_offsets` order; the output rows past `out_capacity` are added to
    the device counter `dropped`, when given, as the plan is built.
    Returns (SparseTensor, out_shape)."""
    ks = coordlib.make_ntuple(kernel_size)
    st = coordlib.make_ntuple(stride)
    pd = coordlib.make_ntuple(padding)
    out_shape = spconv_out_shape(in_shape, ks, st, pd)
    cap = out_capacity or x.capacity
    key = ("spconv", tuple(in_shape), ks, st, pd)
    plan = x.kmaps.get(key)
    if plan is None:
        with span(PLAN):
            out_coords, out_nnz = spconv_downsample(x.coords, ks, st, pd,
                                                    out_shape, cap, dropped)
            # share the level's key table with the SubM convs (conv3d caches
            # it under the same key)
            tkey = ("table", x.stride)
            table = x.kmaps.get(tkey)
            if table is None:
                gs = ((int(in_shape[0]), int(in_shape[1]), int(in_shape[2]),
                       int(batch_size)) if batch_size and x.coords_sorted
                      else None)
                table = coordlib.build_table(x.coords,
                                             assume_sorted=x.coords_sorted,
                                             grid_shape=gs)
                x.kmaps[tkey] = table
            plan = build_spconv_plan(x.coords, out_coords, out_nnz, ks, st, pd,
                                     in_capacity=x.capacity,
                                     in_sorted=x.coords_sorted, table=table)
        x.kmaps[key] = plan
    feats = apply_conv_plan(x.feats, weight, plan)
    # every spconv level is a new unit lattice: fresh caches, so submanifold
    # plan keys do not collide across levels; unique_coords sorts the rows
    out = SparseTensor(feats=feats, coords=plan.out_coords, nnz=plan.out_nnz,
                       stride=(1, 1, 1), cmaps={}, kmaps={},
                       base_sorted=True, coords_sorted=True)
    out.cmaps[out.stride] = (out.coords, out.nnz)
    return out, out_shape


def to_dense_bev(x: SparseTensor, spatial_shape: Tuple[int, int, int],
                 batch_size: int) -> torch.Tensor:
    """SparseConvTensor.dense() + reshape: scatter the voxels into
    (B, C * D, H, W) with D = z extent, H = y, W = x, C outer."""
    w, h, d = (int(v) for v in spatial_shape)
    c = x.feats.shape[1]
    xx, yy, zz, bb = (x.coords[:, i] for i in range(4))
    valid = ((xx >= 0) & (xx < w) & (yy >= 0) & (yy < h) & (zz >= 0)
             & (zz < d) & (bb >= 0) & (bb < batch_size))
    cells = batch_size * d * h * w
    flat = ((bb.long() * d + zz) * h + yy) * w + xx
    flat = torch.where(valid, flat, torch.full_like(flat, cells))
    dense = x.feats.new_zeros((cells + 1, c))
    dense[flat] = torch.where(valid[:, None], x.feats,
                              torch.zeros_like(x.feats))
    dense = dense[:-1].reshape(batch_size, d, h, w, c)
    return dense.permute(0, 4, 1, 2, 3).reshape(batch_size, c * d, h, w)
