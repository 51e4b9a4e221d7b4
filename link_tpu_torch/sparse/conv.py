"""Sparse 3D convolution: kernel-map planning + gather-matmul.

PyTorch counterpart of `link_tpu/sparse/conv.py`, in its per-tap query
form. A plan holds a dense gather-form kernel map `in_idx[K, M_out]` over
the fixed output capacity:

    forward:    y[j] = sum_k feats[in_idx[k, j]] @ W[k]     (miss -> 0)
    transposed: y[i] = sum_k feats[inv_idx[k, i]] @ W[k]

Both run through the hand-written `gather_conv` kernel, and every plan's
join through the `sorted_join` kernel (`link_tpu_torch/ops/kernels.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..ops import kernels
from . import coords as coordlib
from . import ops as spops
from .tensor import ConvPlan, SparseTensor


def mirror_perm(offsets: np.ndarray):
    """Static tap permutation m with offsets[m[k]] == -offsets[k], or None
    if the offset set is not symmetric (even kernels / strided taps)."""
    offs = np.asarray(offsets)
    lut = {tuple(o): i for i, o in enumerate(offs.tolist())}
    perm = []
    for o in offs.tolist():
        j = lut.get((-o[0], -o[1], -o[2]))
        if j is None:
            return None
        perm.append(j)
    return tuple(perm)


def build_conv_plan(in_coords: torch.Tensor, out_coords: torch.Tensor,
                    out_nnz: torch.Tensor, offsets, in_capacity: int,
                    in_sorted: bool = False,
                    table: Optional[coordlib.CoordTable] = None) -> ConvPlan:
    """Kernel map: for each output row and tap, the input row at
    out_coord + offset (or -1). One join over all K * M queries."""
    if table is None:
        table = coordlib.build_table(in_coords, assume_sorted=in_sorted)
    offs_np = np.asarray(offsets)
    mir = mirror_perm(offs_np) if out_coords is in_coords else None
    offs = torch.tensor(offs_np, dtype=torch.int32,
                        device=out_coords.device)             # (K, 3)
    qxyz = out_coords[None, :, :3] + offs[:, None, :]         # (K, M, 3)
    qb = out_coords[None, :, 3:].expand(offs.shape[0], -1, -1)
    in_idx = table.query(torch.cat([qxyz, qb], dim=-1))       # (K, M)
    return ConvPlan(in_idx=in_idx, out_coords=out_coords, out_nnz=out_nnz,
                    in_capacity=in_capacity, mirror=mir)


def invert_plan(plan: ConvPlan) -> torch.Tensor:
    """Inverse kernel map: inv[k, i] = output row j with in_idx[k, j] == i
    (or -1). Well-defined because j -> in_idx[k, j] is injective per tap."""
    k, m = plan.in_idx.shape
    n = plan.in_capacity
    dev = plan.in_idx.device
    tgt = torch.where(plan.in_idx >= 0, plan.in_idx,
                      torch.full_like(plan.in_idx, n)).long()
    inv = torch.full((k, n + 1), -1, dtype=torch.int32, device=dev)
    src = torch.arange(m, dtype=torch.int32, device=dev).expand(k, m)
    # valid targets are unique per tap; misses all land in the dump column
    inv.scatter_(1, tgt, src)
    return inv[:, :n].contiguous()


def apply_conv_plan(feats: torch.Tensor, weight: torch.Tensor,
                    plan: ConvPlan, transposed: bool = False) -> torch.Tensor:
    """Execute the plan through `gather_conv`. `weight` is (K, Ci, Co).
    The transposed conv gathers over the plan's inverse map, so feats live
    on the plan's output side and the result on its input side."""
    idx = plan.inv_idx if transposed else plan.in_idx
    if idx is None:
        raise ValueError("transposed apply needs plan.inv_idx (invert_plan)")
    return kernels.gather_conv(feats, idx, weight)


def conv3d(x: SparseTensor, weight: torch.Tensor,
           kernel_size: Union[int, Tuple[int, ...]],
           stride: Union[int, Tuple[int, ...]] = 1,
           dilation: Union[int, Tuple[int, ...]] = 1,
           transposed: bool = False,
           out_capacity: Optional[int] = None) -> SparseTensor:
    """Sparse conv with kernel-map caching in `x.kmaps`:

      * 1x1x1 stride-1: plain matmul, no coords change;
      * submanifold (stride 1): out coords == in coords;
      * strided: coords downsampled, new coord map registered in cmaps, and
        the inverse map built eagerly for the matching transposed conv;
      * transposed: reuses the plan of the matching down conv and restores
        the cached finer coord map.
    """
    kernel_size = coordlib.make_ntuple(kernel_size)
    stride = coordlib.make_ntuple(stride)
    dilation = coordlib.make_ntuple(dilation)

    if kernel_size == (1, 1, 1) and stride == (1, 1, 1) and dilation == (1, 1, 1):
        # weight rounded to the feature dtype, products and sum in float32
        dt = x.feats.dtype
        feats = (x.feats.float() @ weight.to(dt).float()).to(dt)
        return x.replace(feats=feats)

    if not transposed:
        key = ("plan", x.stride, kernel_size, stride, dilation)
        strided = any(s > 1 for s in stride)
        out_sorted = True if strided else x.coords_sorted
        plan = x.kmaps.get(key)
        if plan is None:
            offsets = coordlib.kernel_offsets_np(kernel_size, stride=x.stride,
                                                 dilation=dilation)
            if strided:
                cap = out_capacity or x.capacity
                out_coords, out_nnz = spops.spdownsample(
                    x.coords, cap, stride, kernel_size, x.stride)
            else:
                out_coords, out_nnz = x.coords, x.nnz
            # one key table per coordinate map, shared by every plan built
            # at this level (submanifold + down convs)
            tkey = ("table", x.stride)
            table = x.kmaps.get(tkey)
            if table is None:
                table = coordlib.build_table(x.coords,
                                             assume_sorted=x.coords_sorted)
                x.kmaps[tkey] = table
            plan = build_conv_plan(x.coords, out_coords, out_nnz, offsets,
                                   in_capacity=x.capacity,
                                   in_sorted=x.coords_sorted, table=table)
            if strided and plan.mirror is None:
                # eager inverse map for the U-Net's matching transposed conv
                plan = plan.replace(inv_idx=invert_plan(plan))
            x.kmaps[key] = plan

        feats = apply_conv_plan(x.feats, weight, plan)
        new_stride = tuple(x.stride[k] * stride[k] for k in range(3))
        out = SparseTensor(feats=feats, coords=plan.out_coords,
                           nnz=plan.out_nnz, stride=new_stride,
                           cmaps=x.cmaps, kmaps=x.kmaps,
                           base_sorted=x.base_sorted,
                           coords_sorted=out_sorted,
                           grid_extent=x.grid_extent)
    else:
        tensor_stride = tuple(x.stride[k] // stride[k] for k in range(3))
        tkey = ("plan", tensor_stride, kernel_size, stride, dilation)
        plan = x.kmaps[tkey]
        if plan.inv_idx is None:
            plan = plan.replace(inv_idx=invert_plan(plan))
            x.kmaps[tkey] = plan
        feats = apply_conv_plan(x.feats, weight, plan, transposed=True)
        fine_coords, fine_nnz = x.cmaps[tensor_stride]
        # strided-conv products are sorted (unique_coords); the creation
        # stride map carries the creation flag
        fine_sorted = (tensor_stride != (1, 1, 1)) or x.base_sorted
        out = SparseTensor(feats=feats, coords=fine_coords, nnz=fine_nnz,
                           stride=tensor_stride, cmaps=x.cmaps,
                           kmaps=x.kmaps, base_sorted=x.base_sorted,
                           coords_sorted=fine_sorted,
                           grid_extent=x.grid_extent)

    out.cmaps.setdefault(out.stride, (out.coords, out.nnz))
    return out
