"""torch.nn modules over SparseTensor: conv, norm, linear, activation,
pooling and crop.

PyTorch counterpart of `link_tpu/nn/modules.py`. Parameter names and
layouts follow the reference torchsparse modules, so a reference
`state_dict` loads directly: `SparseConv3d.kernel` is (K, Ci, Co) ((Ci, Co)
for a 1x1x1 kernel), `Linear.weight` is torch's (out, in), and
`SparseBatchNorm` keeps BatchNorm1d's parameters and buffers.

Parameters are drawn on the CPU from an optional `torch.Generator` and then
moved to `device`. `SparseConv3d` and `SparseBatchNorm` also take a
`DenseGrid` (the det backbone's dense levels): the submanifold conv runs as
a masked dense conv, and the norm's statistics are taken over the occupied
cells only, its output re-zeroed at the empty ones.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..sparse import conv as spconv
from ..sparse import coords as coordlib
from ..sparse.dense_grid import DenseGrid, dense_subm_conv
from ..sparse.tensor import SparseTensor
from . import remat


def _uniform(shape, bound: float, generator, device) -> nn.Parameter:
    w = torch.empty(shape, dtype=torch.float32).uniform_(
        -bound, bound, generator=generator)
    return nn.Parameter(w.to(device))


class SparseConv3d(nn.Module):
    """Sparse conv; weight layout (K, Ci, Co) and the reference's uniform
    1/sqrt(fan * K) init (torchsparse nn/modules/conv.py:36-64)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, ...]] = 3,
                 stride: Union[int, Tuple[int, ...]] = 1, dilation: int = 1,
                 transposed: bool = False,
                 out_capacity: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size = coordlib.make_ntuple(kernel_size)
        self.stride = stride
        self.dilation = dilation
        self.transposed = transposed
        self.out_capacity = out_capacity
        kv = int(np.prod(self.kernel_size))
        fan = out_channels if transposed else in_channels
        std = 1.0 / math.sqrt(fan * kv)
        shape = ((kv, in_channels, out_channels) if kv > 1
                 else (in_channels, out_channels))
        self.kernel = _uniform(shape, std, generator, device)

    def forward(self, st: SparseTensor) -> SparseTensor:
        if isinstance(st, DenseGrid):
            if (self.transposed or self.dilation != 1
                    or coordlib.make_ntuple(self.stride) != (1, 1, 1)):
                raise ValueError("a DenseGrid takes only the submanifold "
                                 "conv (stride 1, no dilation)")
            return dense_subm_conv(st, self.kernel, self.kernel_size)
        return spconv.conv3d(st, self.kernel, kernel_size=self.kernel_size,
                             stride=self.stride,
                             dilation=self.dilation,
                             transposed=self.transposed,
                             out_capacity=self.out_capacity)


class SparseBatchNorm(nn.Module):
    """BatchNorm over the valid voxel rows (BatchNorm1d semantics: eps 1e-5,
    momentum 0.1, biased variance to normalize, unbiased for the running
    estimate). Eval mode uses the running statistics. With `sync_group` a
    process group (`sync_batch_norms`), training takes the statistics over
    every replica's rows: SyncBN, JAX's `axis_name`."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, device=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long, device=device))
        self.sync_group = None

    def forward(self, st: SparseTensor) -> SparseTensor:
        f32 = st.feats.to(torch.float32)
        dense = isinstance(st, DenseGrid)
        if self.training:
            # a dense grid's occupied cells are the sparse tensor's rows
            mask = (st.mask[..., None] if dense
                    else st.valid_mask()[:, None]).to(torch.float32)
            red = tuple(range(f32.dim() - 1))
            n = mask.sum()
            s1 = (f32 * mask).sum(red)
            s2 = (f32.square() * mask).sum(red)
            if self.sync_group is not None:
                n, s1, s2 = _sum_over_replicas(self.sync_group, n, s1, s2)
            n = torch.clamp(n, min=1.0)
            mean = s1 / n
            # torch.maximum, not clamp: where the variance is exactly 0 (a
            # level with one voxel, a dead channel) it halves the gradient
            # as jnp.maximum does; clamp would pass it whole
            var = s2 / n - mean.square()
            var = torch.maximum(var, torch.zeros_like(var))
            # a rematerialized block's replay (nn/remat.py) runs this
            # forward a second time in the step: the statistics move once
            if not remat.replaying():
                with torch.no_grad():
                    unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                    self.running_mean.mul_(1 - self.momentum).add_(
                        self.momentum * mean)
                    self.running_var.mul_(1 - self.momentum).add_(
                        self.momentum * unbiased)
                    self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        out = (f32 - mean) * inv + self.bias
        if dense:
            # re-zero the empty cells (the affine bias is nonzero there)
            return st.masked(out.to(st.feats.dtype))
        return st.replace(feats=out.to(st.feats.dtype))


class _AllReduceSum(torch.autograd.Function):
    """The sum over the replicas of `group`, whose backward sums the
    replicas' gradients (`torch.distributed.nn.functional.all_reduce`). The
    reduced value is kept for a rematerialized block's replay
    (`remat.saved`), which then makes no collective call: a step makes the
    same calls, in the same order on every rank, with remat as without."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group

        def reduce():
            out = t.clone(memory_format=torch.contiguous_format)
            torch.distributed.all_reduce(out, group=group)
            return out
        return remat.saved(reduce)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(g, group=ctx.group)
        return g, None


def differentiable_all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the replicas of `group`, whose backward sums the
    replicas' gradients (`_AllReduceSum`)."""
    return _AllReduceSum.apply(t, group)


def _sum_over_replicas(group, *tensors):
    """Each tensor summed over the replicas of `group` (JAX's `psum`),
    through one all-reduce that autograd differentiates: the backward sums
    the replicas' gradients in turn."""
    flat = differentiable_all_reduce(
        torch.cat([t.reshape(-1) for t in tensors]), group)
    return tuple(v.view_as(t) for t, v in
                 zip(tensors, flat.split([t.numel() for t in tensors])))


def sync_batch_norms(model: nn.Module, group) -> nn.Module:
    """Make every BatchNorm of `model`, sparse and dense, a SyncBN over the
    replicas of process group `group` (None: each replica's own batch, the
    default): what JAX's `bn_axis` does to the modules it reaches. Returns
    `model`."""
    for m in model.modules():
        if isinstance(m, (SparseBatchNorm, nn.modules.batchnorm._BatchNorm)):
            m.sync_group = group
    return model


class SparseLayerNorm(nn.Module):
    """LayerNorm over the channel dim, in float32, eps 1e-6 as in the ELK
    blocks; returns the input dtype."""

    def __init__(self, num_features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        f32 = feats.to(torch.float32)
        mean = f32.mean(-1, keepdim=True)
        var = (f32 - mean).square().mean(-1, keepdim=True)
        out = (f32 - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return out.to(feats.dtype)


class Linear(nn.Module):
    """Dense layer with torch nn.Linear's default init bound 1/sqrt(fan_in).
    The weight is rounded to the input dtype, the product summed in float32
    and rounded back; an f32 bias promotes the result as in the JAX model."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        std = 1.0 / math.sqrt(in_features)
        self.weight = _uniform((out_features, in_features), std, generator,
                               device)
        self.bias = (_uniform((out_features,), std, generator, device)
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        y = (x.to(torch.float32) @ self.weight.to(dt).to(torch.float32).T).to(dt)
        if self.bias is not None:
            y = y + self.bias
        return y


class SparseReLU(nn.Module):
    def forward(self, st: SparseTensor) -> SparseTensor:
        return relu(st)


def relu(st: SparseTensor) -> SparseTensor:
    return st.replace(feats=torch.relu(st.feats))


def _batch_segments(st: SparseTensor, max_batch: int) -> torch.Tensor:
    """Each row's batch index, `max_batch` for padding rows (the dump
    segment)."""
    b = st.coords[:, 3].long()
    return torch.where(st.valid_mask(), b, torch.full_like(b, max_batch))


class GlobalAveragePool(nn.Module):
    """Per-batch-element mean over the valid voxels, (max_batch, C)
    (torchsparse nn/modules/pooling.py GlobalAveragePool); the sums in the
    feature dtype, the counts in float32, as the JAX module."""

    def __init__(self, max_batch: int = 16):
        super().__init__()
        self.max_batch = max_batch

    def forward(self, st: SparseTensor) -> torch.Tensor:
        seg = _batch_segments(st, self.max_batch)
        n = self.max_batch + 1
        sums = st.feats.new_zeros((n, st.feats.shape[1])).index_add(
            0, seg, st.feats)
        cnts = torch.zeros(n, dtype=torch.float32, device=st.device
                           ).index_add(0, seg, torch.ones_like(
                               seg, dtype=torch.float32))
        return (sums[:self.max_batch]
                / torch.clamp(cnts[:self.max_batch, None], min=1.0))


class GlobalMaxPool(nn.Module):
    """Per-batch-element max over the valid voxels, (max_batch, C); an
    element without voxels gives zeros."""

    def __init__(self, max_batch: int = 16):
        super().__init__()
        self.max_batch = max_batch

    def forward(self, st: SparseTensor) -> torch.Tensor:
        seg = _batch_segments(st, self.max_batch)
        neg = torch.full((self.max_batch + 1, st.feats.shape[1]),
                         -torch.inf, dtype=torch.float32, device=st.device)
        src = st.feats.to(torch.float32)
        out = neg.scatter_reduce(0, seg[:, None].expand_as(src), src, "amax")
        out = out[:self.max_batch]
        return torch.where(torch.isfinite(out), out,
                           torch.zeros_like(out)).to(st.feats.dtype)


def crop(st: SparseTensor, loc_min, loc_max) -> SparseTensor:
    """Keep the voxels inside [loc_min, loc_max) (torchsparse
    nn/modules/crop.py). Fixed-capacity form: the rows outside become
    padding (sentinel coords) and `nnz` counts the rest."""
    c = st.coords
    lo = torch.as_tensor(loc_min, dtype=torch.int32, device=c.device)
    hi = torch.as_tensor(loc_max, dtype=torch.int32, device=c.device)
    keep = st.valid_mask() & ((c[:, :3] >= lo) & (c[:, :3] < hi)).all(1)
    coords = torch.where(keep[:, None], c,
                         torch.full_like(c, coordlib.INVALID_COORD))
    return st.replace(coords=coords, nnz=keep.sum().to(torch.int32))
