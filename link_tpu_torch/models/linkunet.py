"""LinK U-Net segmentation model (reference linkunet.py:188-385, ELKUNet).

PyTorch counterpart of `link_tpu/models/linkunet.py`, inference path.
MinkUNet topology with a parallel ELK branch at each of the 4 encoder
levels: x_l = ReLU(stage_tail(stage(x)) + elk_tail(ELK(x, stride*s, r))).
Submodules are named after the reference `state_dict` keys, so a reference
checkpoint loads with `load_state_dict(strict=True)`.

Static `capacities` bound the voxel count per stride level (index 0 =
stride 1 ... index 4 = stride 16); `aux_capacities` bound ELK aux cells per
level (default: the next level's capacity, as in the JAX model).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..nn.modules import Linear, SparseBatchNorm, SparseConv3d, SparseReLU
from ..sparse.tensor import SparseTensor, cat
from .blocks import BasicConvolutionBlock, BasicDeconvolutionBlock, ResidualBlock
from .elk import ELKBlock

# Per-scan voxel capacities by stride level (1, 2, 4, 8, 16) for the 80k
# training cap (the JAX package's tools/calibrate_capacities.py).
DEFAULT_CAPACITIES = (84992, 62464, 43520, 27648, 14336)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ELKUNet(nn.Module):

    def __init__(self, num_classes: int, cr: float = 1.0, r: int = 2,
                 s: int = 3, groups: int = 1, baseop: str = "cos_x",
                 in_channels: int = 4,
                 capacities: Tuple[int, ...] = DEFAULT_CAPACITIES,
                 aux_capacities: Optional[Tuple[int, ...]] = None,
                 dtype: str = "float32",
                 grid_extent: Optional[Tuple[int, int, int, int]] = None,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        self.r, self.s = r, s
        self.dtype = _DTYPES[dtype]
        self.grid_extent = grid_extent
        cs = [int(cr * c) for c in [64] * 9]
        caps = tuple(capacities)
        aux_caps = tuple(aux_capacities or caps[1:])
        kw = dict(device=device, generator=generator)

        self.stem = nn.Sequential(
            SparseConv3d(in_channels, cs[0], 3, **kw),
            SparseBatchNorm(cs[0], device=device), SparseReLU(),
            SparseConv3d(cs[0], cs[0], 3, **kw),
            SparseBatchNorm(cs[0], device=device), SparseReLU())
        for lvl in range(1, 5):
            cin, cout = cs[lvl - 1], cs[lvl]
            self.add_module(f"down{lvl}", nn.Sequential(
                BasicConvolutionBlock(cin, cin, ks=2, stride=2,
                                      out_capacity=caps[lvl], **kw)))
            self.add_module(f"stage{lvl}", nn.Sequential(
                ResidualBlock(cin, cout, **kw), ResidualBlock(cout, cout, **kw)))
            self.add_module(f"stage{lvl}_tail", nn.Sequential(
                SparseConv3d(cout, cout, 3, **kw),
                SparseBatchNorm(cout, device=device)))
            self.add_module(f"elk{lvl}", ELKBlock(
                cin, aux_capacity=aux_caps[lvl - 1], groups=groups,
                baseop=baseop, **kw))
            self.add_module(f"elk{lvl}_tail", nn.Sequential(
                SparseConv3d(cin, cout, 3, **kw),
                SparseBatchNorm(cout, device=device)))
        # decoder: (input width, output width, skip width) per level
        for lvl, (cin, cout, skip) in enumerate(
                ((cs[4], cs[5], cs[3]), (cs[5], cs[6], cs[2]),
                 (cs[6], cs[7], cs[1]), (cs[7], cs[8], cs[0])), start=1):
            self.add_module(f"up{lvl}", nn.ModuleList([
                BasicDeconvolutionBlock(cin, cout, ks=2, stride=2, **kw),
                nn.Sequential(ResidualBlock(cout + skip, cout, **kw),
                              ResidualBlock(cout, cout, **kw))]))
        self.classifier = nn.Sequential(Linear(cs[8], num_classes, **kw))

    def forward(self, x: SparseTensor) -> torch.Tensor:
        x = x.replace(feats=x.feats.to(self.dtype))
        if self.grid_extent is not None and x.grid_extent is None:
            x = x.replace(grid_extent=tuple(self.grid_extent))

        st = self.stem(x)
        feats_list = [st]
        for lvl in range(1, 5):
            st_0 = getattr(self, f"down{lvl}")(st)
            y = getattr(self, f"stage{lvl}")(st_0)
            y = getattr(self, f"stage{lvl}_tail")(y)
            lk = getattr(self, f"elk{lvl}")(st_0, st_0.stride[0] * self.s,
                                           self.r)
            lk = getattr(self, f"elk{lvl}_tail")(lk)
            st = y.replace(feats=torch.relu(y.feats + lk.feats))
            feats_list.append(st)

        y = feats_list[4]
        for lvl, skip in zip(range(1, 5), feats_list[3::-1]):
            deconv, res = getattr(self, f"up{lvl}")
            y = deconv(y)
            y = res(cat([y, skip]))
        return self.classifier(y.feats)
