"""SPVCNN baseline: point-voxel U-Net (reference segmentation/core/models/
semantic_kitti/spvcnn.py:82-235).

PyTorch counterpart of `link_tpu/models/spvcnn.py`, inference path, float32
only (the JAX model has no dtype). The voxel U-Net of MinkUNet
(`SparseUNetBody`, widths [32, 32, 64, 128, 256, 256, 128, 96, 96] * cr)
and a point branch that crosses it at 4 junctions through the trilinear
`voxel_to_point` and the mean-pooling `point_to_voxel` (`ops/point.py`),
with point MLPs (Linear + BatchNorm + ReLU, `point_transforms`) on the skip
path and dropout (`dropout_rate`, 0.3 as the reference) before the two
mid-decoder re-voxelizations. The input voxels are the points: their coords
are the float point positions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..nn.modules import Linear, SparseBatchNorm
from ..ops.point import (initial_voxelize, make_point_tensor, point_to_voxel,
                         voxel_to_point)
from ..sparse import coords as coordlib
from ..sparse.tensor import SparseTensor
from .blocks import decoder_level
from .linkunet import DEFAULT_CAPACITIES
from .minkunet import SparseUNetBody

SPVCNN_CHANNELS = (32, 32, 64, 128, 256, 256, 128, 96, 96)


class PointMLP(nn.Sequential):
    """Linear + BatchNorm1d over the valid points + ReLU (spvcnn.py:166-182);
    children named as the reference's Sequential (`0` Linear, `1` norm)."""

    def __init__(self, inc: int, outc: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(Linear(inc, outc, device=device, generator=generator),
                         SparseBatchNorm(outc, device=device))

    def forward(self, feats: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        h = self[0](feats)
        # the norm's statistics run over the valid rows: a view of the
        # points as a sparse tensor whose padding rows are sentinel, as the
        # JAX model builds it (spvcnn.py:40-46)
        rows = torch.where(valid[:, None],
                           torch.zeros((h.shape[0], 4), dtype=torch.int32,
                                       device=h.device),
                           torch.full((h.shape[0], 4), coordlib.INVALID_COORD,
                                      dtype=torch.int32, device=h.device))
        st = SparseTensor(feats=h, coords=rows,
                          nnz=valid.sum().to(torch.int32))
        return torch.relu(self[1](st).feats)


class SPVCNN(SparseUNetBody):
    """`dropout_rate` is the dropout before the two mid-decoder
    re-voxelizations, in training mode only (0 turns it off).
    `dropout_seed` seeds the dropout's own generator on the feature device,
    made at the first training-mode forward; without it a training-mode
    forward with dropout raises. Eval mode draws nothing."""

    def __init__(self, num_classes: int, cr: float = 1.0, pres: float = 0.05,
                 vres: float = 0.05, in_channels: int = 4,
                 capacities: Tuple[int, ...] = DEFAULT_CAPACITIES,
                 dropout_rate: float = 0.3,
                 dropout_seed: Optional[int] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__([int(cr * c) for c in SPVCNN_CHANNELS], in_channels,
                         capacities, device=device, generator=generator)
        cs = self.cs
        self.pres, self.vres = pres, vres
        self.capacities = tuple(capacities)
        self.dropout_rate = float(dropout_rate)
        self.dropout_seed = dropout_seed
        self._dropout_gen: Optional[torch.Generator] = None
        kw = dict(device=device, generator=generator)
        self.point_transforms = nn.ModuleList([
            PointMLP(cs[0], cs[4], **kw), PointMLP(cs[4], cs[6], **kw),
            PointMLP(cs[6], cs[8], **kw)])
        self.classifier = nn.Sequential(Linear(cs[8], num_classes, **kw))

    def _drop(self, f: torch.Tensor) -> torch.Tensor:
        if not self.training or self.dropout_rate == 0:
            return f
        if self.dropout_seed is None:
            raise ValueError("SPVCNN: training-mode dropout needs "
                             "dropout_seed")
        gen = self._dropout_gen
        if gen is None or gen.device != f.device:
            gen = torch.Generator(device=f.device).manual_seed(
                self.dropout_seed)
            self._dropout_gen = gen
        rate = self.dropout_rate
        keep = torch.rand(f.shape, generator=gen, device=f.device) >= rate
        return torch.where(keep, f / (1 - rate), torch.zeros_like(f))

    def forward(self, x: SparseTensor) -> torch.Tensor:
        pt0, pt1, pt2 = self.point_transforms
        z = make_point_tensor(x.feats, x.coords.to(torch.float32), nnz=x.nnz)
        x0, _ = initial_voxelize(z, self.pres, self.vres, self.capacities[0])
        x0 = self.stem(x0)

        z0 = voxel_to_point(x0, z)
        pvalid = z0.valid_mask()

        enc = [x0]
        st = point_to_voxel(x0, z0)
        for lvl in range(1, 5):
            st = getattr(self, f"stage{lvl}")(st)
            enc.append(st)
        _, x1, x2, x3, x4 = enc

        z1 = voxel_to_point(x4, z0)
        z1 = z1.replace(feats=z1.feats + pt0(z0.feats, pvalid))

        y1 = point_to_voxel(x4, z1)
        y1 = y1.replace(feats=self._drop(y1.feats))
        y1 = decoder_level(self, 1, y1, x3)
        y2 = decoder_level(self, 2, y1, x2)
        z2 = voxel_to_point(y2, z1)
        z2 = z2.replace(feats=z2.feats + pt1(z1.feats, pvalid))

        y3 = point_to_voxel(y2, z2)
        y3 = y3.replace(feats=self._drop(y3.feats))
        y3 = decoder_level(self, 3, y3, x1)
        y4 = decoder_level(self, 4, y3, x0)
        z3 = voxel_to_point(y4, z2)
        z3 = z3.replace(feats=z3.feats + pt2(z2.feats, pvalid))
        return self.classifier(z3.feats)
