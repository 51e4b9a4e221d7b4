"""Shared sparse conv blocks (reference linkunet.py:23-91), named after the
reference's `state_dict` keys (`net.0.kernel`, `net.1.weight`,
`downsample.0.kernel`, ...)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn import remat
from ..nn.modules import SparseBatchNorm, SparseConv3d, SparseReLU
from ..sparse.tensor import SparseTensor, cat


class BasicConvolutionBlock(nn.Module):
    """Conv3d + BN + ReLU; rematerializable (`nn/remat.py`)."""

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

    @remat.rematerializable
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
    """Two convs + BN with a projection shortcut when the shape changes;
    rematerializable (`nn/remat.py`)."""

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

    @remat.rematerializable
    def forward(self, x: SparseTensor) -> SparseTensor:
        y = self.net(x)
        sc = self.downsample(x)
        return y.replace(feats=torch.relu(y.feats + sc.feats))


def add_decoder(module: nn.Module, cs, device=None,
                generator: Optional[torch.Generator] = None) -> None:
    """Register the U-Net decoder of ELKUNet, MinkUNet and SPVCNN on
    `module` under the reference's names: up{l} = [transposed conv,
    (two residual blocks over the concat with the skip)], for the
    9-entry width plan `cs`."""
    kw = dict(device=device, generator=generator)
    # (input width, output width, skip width) per level
    for lvl, (cin, cout, skip) in enumerate(
            ((cs[4], cs[5], cs[3]), (cs[5], cs[6], cs[2]),
             (cs[6], cs[7], cs[1]), (cs[7], cs[8], cs[0])), start=1):
        module.add_module(f"up{lvl}", nn.ModuleList([
            BasicDeconvolutionBlock(cin, cout, ks=2, stride=2, **kw),
            nn.Sequential(ResidualBlock(cout + skip, cout, **kw),
                          ResidualBlock(cout, cout, **kw))]))


def decoder_level(module: nn.Module, lvl: int, y: SparseTensor,
                  skip: SparseTensor) -> SparseTensor:
    """Decoder level `lvl` of `add_decoder`: the transposed conv, the
    concat with the skip, the two residual blocks."""
    deconv, res = getattr(module, f"up{lvl}")
    return res(cat([deconv(y), skip]))
