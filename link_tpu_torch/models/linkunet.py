"""LinK U-Net segmentation model (reference linkunet.py:188-385, ELKUNet).

PyTorch counterpart of `link_tpu/models/linkunet.py`.
MinkUNet topology with a parallel ELK branch at each of the 4 encoder
levels: x_l = ReLU(stage_tail(stage(x)) + elk_tail(ELK(x, stride*s, r))).
The stem and that encoder (`ELKSegEncoder`) are ELKEncoder's too
(`models/linkencoder.py`); the decoder is MinkUNet's (`blocks.add_decoder`).
Submodules are named after the reference `state_dict` keys, so a reference
checkpoint loads with `load_state_dict(strict=True)`.

Static `capacities` bound the voxel count per stride level (index 0 =
stride 1 ... index 4 = stride 16); `aux_capacities` bound ELK aux cells per
level (default: the next level's capacity, as in the JAX model).
`remat=True` rematerializes the blocks of `REMAT_BLOCKS` in training under
the JAX model's policy, which keeps the plans and every conv output
(`nn/remat.py`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..nn.modules import Linear, SparseBatchNorm, SparseConv3d, SparseReLU
from ..nn.remat import PLANS_AND_CONV_OUTPUTS, set_remat
from ..sparse.tensor import SparseTensor
from .blocks import (BasicConvolutionBlock, ResidualBlock, add_decoder,
                     decoder_level)
from .elk import ELKBlock

# the blocks that `remat=True` rematerializes, as the JAX models wrap them
# in nn.remat (linkunet.py, linkencoder.py): every residual block (the
# stages' and the decoder's), every down block and every ELK block; the
# stem, the tails and the transposed convs are not
REMAT_BLOCKS = (ResidualBlock, BasicConvolutionBlock, ELKBlock)

# Per-scan voxel capacities by stride level (1, 2, 4, 8, 16) for the 80k
# training cap (the JAX package's tools/calibrate_capacities.py).
DEFAULT_CAPACITIES = (84992, 62464, 43520, 27648, 14336)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ELKSegEncoder(nn.Module):
    """The stem and the 4-level encoder that ELKUNet and ELKEncoder share
    (the reference reuses the module names): level l is
    ReLU(stage_tail(stage(down(x))) + elk_tail(ELK(down(x), stride * s, r))).
    `normalize_coords` is ELKEncoder's cos_x variant of the ELK blocks."""

    def __init__(self, cr: float, r: int, s: int, groups: int, baseop: str,
                 in_channels: int, capacities: Tuple[int, ...],
                 aux_capacities: Optional[Tuple[int, ...]], dtype: str,
                 grid_extent: Optional[Tuple[int, int, int, int]],
                 normalize_coords: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        self.r, self.s = r, s
        self.dtype = _DTYPES[dtype]
        self.grid_extent = grid_extent
        cs = [int(cr * c) for c in [64] * 9]
        self.cs = cs
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
                baseop=baseop, normalize_coords=normalize_coords, **kw))
            self.add_module(f"elk{lvl}_tail", nn.Sequential(
                SparseConv3d(cin, cout, 3, **kw),
                SparseBatchNorm(cout, device=device)))

    def encode(self, x: SparseTensor) -> List[SparseTensor]:
        """[x0, x1, x2, x3, x4]: the stem's output and the four levels'."""
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
        return feats_list


class ELKUNet(ELKSegEncoder):

    def __init__(self, num_classes: int, cr: float = 1.0, r: int = 2,
                 s: int = 3, groups: int = 1, baseop: str = "cos_x",
                 in_channels: int = 4,
                 capacities: Tuple[int, ...] = DEFAULT_CAPACITIES,
                 aux_capacities: Optional[Tuple[int, ...]] = None,
                 dtype: str = "float32",
                 grid_extent: Optional[Tuple[int, int, int, int]] = None,
                 remat: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(cr, r, s, groups, baseop, in_channels, capacities,
                         aux_capacities, dtype, grid_extent, device=device,
                         generator=generator)
        add_decoder(self, self.cs, device=device, generator=generator)
        self.classifier = nn.Sequential(Linear(self.cs[8], num_classes,
                                               device=device,
                                               generator=generator))
        if remat:
            set_remat(self, REMAT_BLOCKS, PLANS_AND_CONV_OUTPUTS)

    def forward(self, x: SparseTensor) -> torch.Tensor:
        feats_list = self.encode(x)
        y = feats_list[4]
        for lvl, skip in zip(range(1, 5), feats_list[3::-1]):
            y = decoder_level(self, lvl, y, skip)
        return self.classifier(y.feats)
