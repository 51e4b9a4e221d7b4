"""Shared sparse conv blocks (reference linkunet.py:23-91), named after the
reference's `state_dict` keys (`net.0.kernel`, `net.1.weight`,
`downsample.0.kernel`, ...)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.modules import SparseBatchNorm, SparseConv3d, SparseReLU
from ..sparse.tensor import SparseTensor


class BasicConvolutionBlock(nn.Module):
    """Conv3d + BN + ReLU."""

    def __init__(self, inc: int, outc: int, ks: int = 3, stride: int = 1,
                 dilation: int = 1, out_capacity: Optional[int] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = nn.Sequential(
            SparseConv3d(inc, outc, ks, stride=stride, dilation=dilation,
                         out_capacity=out_capacity, device=device,
                         generator=generator),
            SparseBatchNorm(outc, device=device),
            SparseReLU())

    def forward(self, x: SparseTensor) -> SparseTensor:
        return self.net(x)


class BasicDeconvolutionBlock(nn.Module):
    """Transposed Conv3d + BN + ReLU."""

    def __init__(self, inc: int, outc: int, ks: int = 3, stride: int = 1,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = nn.Sequential(
            SparseConv3d(inc, outc, ks, stride=stride, transposed=True,
                         device=device, generator=generator),
            SparseBatchNorm(outc, device=device),
            SparseReLU())

    def forward(self, x: SparseTensor) -> SparseTensor:
        return self.net(x)


class ResidualBlock(nn.Module):
    """Two convs + BN with a projection shortcut when the shape changes."""

    def __init__(self, inc: int, outc: int, ks: int = 3, stride: int = 1,
                 dilation: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = nn.Sequential(
            SparseConv3d(inc, outc, ks, stride=stride, dilation=dilation,
                         device=device, generator=generator),
            SparseBatchNorm(outc, device=device),
            SparseReLU(),
            SparseConv3d(outc, outc, ks, stride=1, dilation=dilation,
                         device=device, generator=generator),
            SparseBatchNorm(outc, device=device))
        if inc == outc and stride == 1:
            self.downsample = nn.Identity()
        else:
            self.downsample = nn.Sequential(
                SparseConv3d(inc, outc, 1, stride=stride, device=device,
                             generator=generator),
                SparseBatchNorm(outc, device=device))

    def forward(self, x: SparseTensor) -> SparseTensor:
        y = self.net(x)
        sc = self.downsample(x)
        return y.replace(feats=torch.relu(y.feats + sc.feats))
