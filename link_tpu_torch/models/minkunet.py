"""MinkUNet baseline (reference segmentation/core/models/semantic_kitti/
minkunet.py:91-254): a plain sparse U-Net with no ELK branch.

PyTorch counterpart of `link_tpu/models/minkunet.py`, inference path.
The reference's actual channel plan is cs = [64] * 9 * cr (minkunet.py:98;
the stock SPVNAS [32, 32, 64, 128, 256, 256, 128, 96, 96] list is commented
out there), so that is the default; `channels` selects another plan.
Submodules are named after the reference `state_dict` keys. The reference
also defines `point_transforms`, which its forward never calls; the port
leaves them out, and `utils.convert.load_reference_state_dict` drops their
keys by name (`UNUSED_REFERENCE_KEYS`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..nn.modules import Linear, SparseBatchNorm, SparseConv3d, SparseReLU
from ..sparse.tensor import SparseTensor
from .blocks import (BasicConvolutionBlock, ResidualBlock, add_decoder,
                     decoder_level)
from .linkunet import _DTYPES, DEFAULT_CAPACITIES

MINKUNET_CHANNELS = (64,) * 9


class SparseUNetBody(nn.Module):
    """The modules MinkUNet and SPVCNN share (reference minkunet.py:100-150,
    spvcnn.py:94-144), for the 9-entry width plan `cs`: the stem,
    stage{l} = (down conv, two residual blocks) and the decoder
    (`blocks.add_decoder`)."""

    def __init__(self, cs: Sequence[int], in_channels: int,
                 capacities: Tuple[int, ...], device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cs = cs = [int(c) for c in cs]
        caps = tuple(capacities)
        kw = dict(device=device, generator=generator)
        self.stem = nn.Sequential(
            SparseConv3d(in_channels, cs[0], 3, **kw),
            SparseBatchNorm(cs[0], device=device), SparseReLU(),
            SparseConv3d(cs[0], cs[0], 3, **kw),
            SparseBatchNorm(cs[0], device=device), SparseReLU())
        for lvl in range(1, 5):
            cin, cout = cs[lvl - 1], cs[lvl]
            self.add_module(f"stage{lvl}", nn.Sequential(
                BasicConvolutionBlock(cin, cin, ks=2, stride=2,
                                      out_capacity=caps[lvl], **kw),
                ResidualBlock(cin, cout, **kw),
                ResidualBlock(cout, cout, **kw)))
        add_decoder(self, cs, **kw)


class MinkUNet(SparseUNetBody):
    UNUSED_REFERENCE_KEYS = ("point_transforms.",)

    def __init__(self, num_classes: int, cr: float = 1.0,
                 channels: Sequence[int] = MINKUNET_CHANNELS,
                 in_channels: int = 4,
                 capacities: Tuple[int, ...] = DEFAULT_CAPACITIES,
                 dtype: str = "float32", device="cuda",
                 generator: Optional[torch.Generator] = None):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        super().__init__([int(cr * c) for c in channels], in_channels,
                         capacities, device=device, generator=generator)
        self.dtype = _DTYPES[dtype]
        self.classifier = nn.Sequential(
            Linear(self.cs[8], num_classes, device=device,
                   generator=generator))

    def forward(self, x: SparseTensor) -> torch.Tensor:
        x0 = self.stem(x.replace(feats=x.feats.to(self.dtype)))
        enc = [x0]
        for lvl in range(1, 5):
            enc.append(getattr(self, f"stage{lvl}")(enc[-1]))
        y = enc[4]
        for lvl, skip in zip(range(1, 5), enc[3::-1]):
            y = decoder_level(self, lvl, y, skip)
        return self.classifier(y.feats)
