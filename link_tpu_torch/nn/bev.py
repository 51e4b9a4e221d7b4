"""Sparse -> BEV modules.

PyTorch counterpart of `link_tpu/nn/bev.py` (reference torchsparse
nn/modules/bev.py:16-170):
  * `to_bev_reduction`: mean-pool the voxels sharing a BEV cell (z
    collapsed), a fresh unique over the z-zeroed coords at the same
    capacity;
  * `ToDenseBEVConvolution`: a per-z-plane FC, scatter-added into a dense
    (B, Co, H, W) map;
  * `to_bev_height_compression`: the z slices stacked into channels,
    (B, C * D, H, W).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..sparse import coords as coordlib
from ..sparse import ops as spops
from ..sparse.spconv_engine import to_dense_bev
from ..sparse.tensor import SparseTensor


def to_bev_reduction(x: SparseTensor, dim: int = 2) -> SparseTensor:
    """Mean over the collapsed axis (`dim` 2 is z in the (x, y, z, b)
    coords)."""
    c = x.coords
    zeroed = c.clone()
    zeroed[:, dim] = torch.where(c[:, 0] <= coordlib.INVALID_COORD,
                                 c[:, dim], torch.zeros_like(c[:, dim]))
    out_coords, inverse, out_nnz = coordlib.unique_coords(zeroed, x.capacity)
    counts = spops.spcount(inverse, x.capacity)
    feats = spops.spvoxelize(x.feats, inverse, counts)
    return SparseTensor(feats=feats, coords=out_coords, nnz=out_nnz,
                        stride=x.stride)


class ToDenseBEVConvolution(nn.Module):
    """Per-z FC + scatter-add to (B, Co, H, W) (bev.py:36-120); `kernel`
    (n_z, Ci, Co) uniform +-1/sqrt(Ci), `bias` zero."""

    def __init__(self, in_channels: int, out_channels: int,
                 shape: Tuple[int, int, int], stride: int = 1,
                 bias: bool = False, batch_size: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.shape = tuple(shape)             # (W, H, D) at stride 1
        self.batch_size = batch_size
        d, s = self.shape[2], stride
        n_kernels = d // s if d % s == 0 else d // s + 1
        std = 1.0 / math.sqrt(in_channels)
        self.kernel = nn.Parameter(torch.empty(
            n_kernels, in_channels, out_channels).uniform_(
                -std, std, generator=generator).to(device))
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device))
                     if bias else None)

    def forward(self, x: SparseTensor) -> torch.Tensor:
        w, h, _ = self.shape
        s = x.stride
        z = torch.clamp(x.coords[:, 2] // s[2], 0,
                        self.kernel.shape[0] - 1).long()
        feats = torch.einsum("ni,nio->no", x.feats.to(torch.float32),
                             self.kernel.index_select(0, z))
        hw, hh = w // s[0], h // s[1]
        xx = (x.coords[:, 0] // s[0]).long()
        yy = (x.coords[:, 1] // s[1]).long()
        bb = x.coords[:, 3].long()
        valid = (x.valid_mask() & (xx >= 0) & (xx < hw) & (yy >= 0)
                 & (yy < hh) & (bb >= 0) & (bb < self.batch_size))
        cells = self.batch_size * hh * hw
        flat = torch.where(valid, (bb * hh + yy) * hw + xx,
                           torch.full_like(xx, cells))
        dense = feats.new_zeros((cells + 1, feats.shape[1])).index_add(
            0, flat, torch.where(valid[:, None], feats,
                                 torch.zeros_like(feats)))
        out = dense[:-1].reshape(self.batch_size, hh, hw, -1)
        if self.bias is not None:
            out = out + self.bias
        return out.permute(0, 3, 1, 2).to(x.feats.dtype)


def to_bev_height_compression(x: SparseTensor, shape: Tuple[int, int, int],
                              batch_size: int = 1) -> torch.Tensor:
    """The z slices stacked into channels: (B, C * D, H, W)
    (bev.py:123-170)."""
    s = x.stride
    scale = torch.tensor([s[0], s[1], s[2], 1], dtype=x.coords.dtype,
                         device=x.coords.device)
    invalid = x.coords[:, :1] <= coordlib.INVALID_COORD
    scaled = x.replace(coords=torch.where(invalid, x.coords,
                                          x.coords // scale))
    grid = (shape[0] // s[0], shape[1] // s[1], max(1, shape[2] // s[2]))
    return to_dense_bev(scaled, grid, batch_size)
