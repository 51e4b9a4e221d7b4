"""Functional sparse ops: count / voxelize / devoxelize / downsample.

PyTorch counterpart of `link_tpu/sparse/ops.py`. Scatter reductions are
index-adds into a table with one extra dump row, which takes the misses
(idx == -1) and is cut off. PyTorch autograd differentiates all of them;
`spdevoxelize` with an inverse map has a gather-form backward of its own,
and so has the float32 `segment_sum`, which keeps its value for a
rematerialized block's replay (`nn/remat.py`).

Their callers are the point ops (`ops/point.py`), the BEV and reader
poolings, the ELK block's dense aux path (`ops/elk.elk_aux_window_dense`)
and the reference composition `ops/elk.voxel_to_aux` / `aux_to_voxel`. The
ELK block's sparse aux path takes none of them: it runs
`ops/elk.elk_aggregate`, gather-form kernels over its own plan.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..nn import remat
from . import coords as coordlib


def _dump_index(idx: torch.Tensor, dump: int) -> torch.Tensor:
    return torch.where(idx >= 0, idx, torch.full_like(idx, dump)).long()


def spcount(idx: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Histogram of non-negative indices."""
    safe = _dump_index(idx, num_segments)
    out = torch.zeros(num_segments + 1, dtype=torch.int32, device=idx.device)
    out.index_add_(0, safe, torch.ones_like(safe, dtype=torch.int32))
    return out[:num_segments]


class _SegmentSum(torch.autograd.Function):
    """out = zeros(num_segments, C).index_add_(0, index, src), whose
    backward gathers: d_src = g[index]. The sum is kept for a
    rematerialized block's replay (`remat.saved`): on the card its atomic
    adds round in another order each time, and the replay must give the
    forward's value to the bit."""

    @staticmethod
    def forward(ctx, src, index, num_segments):
        ctx.save_for_backward(index)
        return remat.saved(lambda: src.new_zeros(
            (num_segments, src.shape[1])).index_add_(0, index, src))

    @staticmethod
    def backward(ctx, g):
        index, = ctx.saved_tensors
        return g.index_select(0, index), None, None


def segment_sum(src: torch.Tensor, index: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """(num_segments, C) sums of the rows of `src` by `index` (int64, each
    in [0, num_segments)), differentiable in `src`."""
    return _SegmentSum.apply(src, index, num_segments)


def spvoxelize(feats: torch.Tensor, idx: torch.Tensor,
               counts: torch.Tensor) -> torch.Tensor:
    """Mean-pool N rows into M segments by idx map (-1 = dropped); count 0
    gives zeros. Sums in float32 whatever the feature dtype."""
    m = counts.shape[0]
    safe = _dump_index(idx, m)
    summed = segment_sum(feats.to(torch.float32), safe, m + 1)
    denom = torch.clamp(counts, min=1).to(torch.float32)[:, None]
    return (summed[:m] / denom).to(feats.dtype)


def _spdevoxelize_impl(feats: torch.Tensor, idx: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    n_in, c = feats.shape
    ext = torch.cat([feats, feats.new_zeros((1, c))])
    safe = _dump_index(idx, n_in)
    w = torch.where(idx >= 0, weights, torch.zeros_like(weights)).to(
        feats.dtype)
    acc = torch.zeros((idx.shape[0], c), dtype=torch.float32,
                      device=feats.device)
    for k in range(idx.shape[1]):
        # index_select, not ext[...]: its backward is an index_add_, where
        # advanced indexing's is a sort-based index_put_ that took 90% of a
        # training step on the H100
        acc += (ext.index_select(0, safe[:, k])
                * w[:, k, None]).to(torch.float32)
    return acc.to(feats.dtype)


class _DevoxelizeInv(torch.autograd.Function):
    """Gather-sum whose feature backward is itself a gather-sum over the
    inverse map (link_tpu/sparse/ops.py:72-100). `weights` must be constant
    all-ones and gets no gradient."""

    @staticmethod
    def forward(ctx, feats, idx, weights, inv_idx):
        ctx.save_for_backward(inv_idx)
        return _spdevoxelize_impl(feats, idx, weights)

    @staticmethod
    def backward(ctx, g):
        inv_idx, = ctx.saved_tensors
        d_feats = _spdevoxelize_impl(g, inv_idx,
                                     torch.ones_like(inv_idx, dtype=g.dtype))
        return d_feats, None, None, None


def spdevoxelize(feats: torch.Tensor, idx: torch.Tensor,
                 weights: torch.Tensor,
                 inv_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted gather-sum: out[i] = sum_k w[i, k] * feats[idx[i, k]];
    idx -1 contributes zero. Sums in float32.

    `inv_idx` (optional, (n_in, K)): inverse map with idx[inv_idx[j, k], k]
    == j wherever inv_idx[j, k] >= 0, covering every valid (i, k) pair once.
    When given, the backward runs in gather form over it instead of
    autograd's scatter-add; `weights` must then be constant all-ones."""
    if inv_idx is not None:
        return _DevoxelizeInv.apply(feats, idx, weights, inv_idx)
    return _spdevoxelize_impl(feats, idx, weights)


def spdownsample(coords: torch.Tensor, out_capacity: int,
                 stride: Union[int, Tuple[int, ...]] = 2,
                 kernel_size: Union[int, Tuple[int, ...]] = 2,
                 tensor_stride: Union[int, Tuple[int, ...]] = 1):
    """Strided coordinate downsample, fast path only (stride == kernel_size
    or stride == 1 per axis). Returns (out_coords, out_nnz); coordinates
    keep original units (multiples of stride * tensor_stride)."""
    stride = coordlib.make_ntuple(stride)
    kernel_size = coordlib.make_ntuple(kernel_size)
    tensor_stride = coordlib.make_ntuple(tensor_stride)
    if not all(stride[k] in (1, kernel_size[k]) for k in range(3)):
        raise NotImplementedError(
            "general (offset-expansion) downsample: stride must be 1 or "
            "kernel_size on every axis")
    ss = torch.tensor([s * t for s, t in zip(stride, tensor_stride)],
                      dtype=torch.int32, device=coords.device)
    xyz = coords[:, :3]
    # sentinel rows must stay sentinel after the floor division
    is_pad = xyz[:, :1] <= coordlib.INVALID_COORD
    new_xyz = torch.where(is_pad, xyz,
                          torch.div(xyz, ss, rounding_mode="floor") * ss)
    new_coords = torch.cat([new_xyz, coords[:, 3:]], dim=1)
    out_coords, _, out_nnz = coordlib.unique_coords(new_coords, out_capacity)
    return out_coords, out_nnz
