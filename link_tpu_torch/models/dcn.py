"""Deformable convolution (DCN v1), FeatureAdaption and DCNSepHead.

PyTorch counterpart of `link_tpu/models/dcn.py` (reference
detection/det3d/models/bbox_heads/center_head.py:27-66,114-162; sampling
rules of det3d/ops/dcn/src/deform_conv_cuda_kernel.cu: bilinear
interpolation where a corner contributes only inside the map, and
`deformable_group` partitions the input channels, each partition reading
its own offset field).

`deform_conv2d` is plain PyTorch: per deformable group and tap, four corner
rows are gathered with `index_select` (whose backward is an index_add, not
the sort of advanced indexing's), weighted in float32 and summed, and the
samples of all taps and groups meet the weight in one matmul. Gradients of
the offsets come from autograd through the bilinear weights, as in JAX.

Module layout and `state_dict` keys follow the reference:
`feature_adapt_cls.conv_offset.{weight,bias}` (a 1x1 Conv2d),
`feature_adapt_cls.conv_adaption.weight` (the DeformConv's (Co, Ci, kh,
kw), no bias), `cls_head.{0,1,3}` (Conv3x3 + BN + ReLU + Conv3x3) and
`task_head.<branch>.{0,1,3}` (the SepHead branches but hm).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .rpn import run_dense


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor,
                  weight: torch.Tensor, kernel_size: int = 3,
                  deformable_groups: int = 4,
                  padding: Optional[int] = None) -> torch.Tensor:
    """DCN v1 forward. x (B, H, W, C); offset (B, H, W, G * K * 2) laid out
    as (group, tap, (dy, dx)) with the taps in row-major (ky, kx) order;
    weight (K, C, Co). The sampling coordinates stay float32 whatever the
    dtype of x; the samples are rounded to it and multiplied with the
    weight in it, summed in float32. Returns (B, H, W, Co) in x.dtype."""
    b, h, w, c = x.shape
    ks = kernel_size
    k = ks * ks
    g = deformable_groups
    co = weight.shape[2]
    if padding is None:
        padding = (ks - 1) // 2
    if c % g or offset.shape[-1] != g * k * 2:
        raise ValueError("channels must split into the groups, and the "
                         "offsets hold G * K * 2 channels")
    cg = c // g
    m = h * w
    dev = x.device
    off = offset.to(torch.float32).reshape(b, m, g, k, 2)
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    tap = torch.arange(k, device=dev)
    kky = (tap // ks - padding).to(torch.float32)
    kkx = (tap % ks - padding).to(torch.float32)
    ly = gy.reshape(1, m, 1, 1) + kky + off[..., 0]            # (B, M, G, K)
    lx = gx.reshape(1, m, 1, 1) + kkx + off[..., 1]
    y0 = torch.floor(ly)
    x0 = torch.floor(lx)
    wy = ly - y0                                               # of y0 + 1
    wx = lx - x0                                               # of x0 + 1
    y0 = y0.long()
    x0 = x0.long()

    # rows of the table: (b, pixel, group), each of cg channels
    table = x.reshape(b * m * g, cg)
    base = (torch.arange(b, device=dev).reshape(b, 1, 1, 1) * m) * g \
        + torch.arange(g, device=dev).reshape(1, 1, g, 1)
    s = None
    for dy, wrow in ((0, 1.0 - wy), (1, wy)):
        yy = y0 + dy
        for dx, wcol in ((0, 1.0 - wx), (1, wx)):
            xx = x0 + dx
            inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            pix = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
            rows = table.index_select(0, (base + pix * g).reshape(-1))
            wgt = torch.where(inside, wrow * wcol, torch.zeros_like(wrow))
            v = rows.reshape(b, m, g, k, cg).to(torch.float32) * wgt[..., None]
            s = v if s is None else s + v
    # (B, M, G, K, Cg) -> (B * M, K * C), channels group-major as in x
    s = s.to(x.dtype).permute(0, 1, 3, 2, 4).reshape(b * m, k * c)
    out = s @ weight.to(x.dtype).reshape(k * c, co)
    return out.reshape(b, h, w, co)


class FeatureAdaption(nn.Module):
    """Offsets from a 1x1 conv (weight zero at init) -> DCN v1 -> ReLU
    (center_head.py:27-66; the DeformConv has no bias). The offsets are
    computed in float32 whatever the features' dtype: they are
    coordinates."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, deformable_groups: int = 4,
                 device=None):
        super().__init__()
        k = kernel_size * kernel_size
        self.kernel_size = kernel_size
        self.deformable_groups = deformable_groups
        self.conv_offset = nn.Conv2d(in_channels, deformable_groups * k * 2,
                                     1, bias=True, device=device)
        self.conv_adaption = nn.Module()
        self.conv_adaption.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size,
            device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX module's init: the offset conv's weight zero (the
        reference's init_offset) and its bias uniform +-1/sqrt(fan_in)
        (torch Conv2d's default); the deform weight normal with std
        sqrt(2 / fan_in). Drawn on the CPU."""
        with torch.no_grad():
            w = self.conv_offset.weight
            w.zero_()
            bound = 1.0 / math.sqrt(w.shape[1])
            b = self.conv_offset.bias
            b.copy_(torch.empty(b.shape).uniform_(-bound, bound,
                                                  generator=generator))
            dw = self.conv_adaption.weight
            std = math.sqrt(2.0 / dw[0].numel())
            dw.copy_(torch.empty(dw.shape).normal_(0.0, std,
                                                   generator=generator))

    def deform_weight(self) -> torch.Tensor:
        """(Co, Ci, kh, kw) -> deform_conv2d's (K, Ci, Co), taps row-major."""
        co, ci, kh, kw = self.conv_adaption.weight.shape
        return self.conv_adaption.weight.permute(2, 3, 1, 0).reshape(
            kh * kw, ci, co)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) -> (B, H, W, Co) in x.dtype."""
        off = F.linear(x.to(torch.float32),
                       self.conv_offset.weight[:, :, 0, 0],
                       self.conv_offset.bias)
        y = deform_conv2d(x, off, self.deform_weight(),
                          kernel_size=self.kernel_size,
                          deformable_groups=self.deformable_groups)
        return torch.relu(y)


class DCNSepHead(nn.Module):
    """Separate deformable feature adaption for the heatmap and the
    regression branches (center_head.py:114-162): hm <- cls_head(adapt_cls
    (x)), every other branch <- its SepHead branch over adapt_reg(x)."""

    def __init__(self, cin: int, num_cls: int, init_bias: float = -2.19,
                 device=None):
        super().__init__()
        from .center_head import SepHead, head_branch
        self.feature_adapt_cls = FeatureAdaption(cin, cin, device=device)
        self.feature_adapt_reg = FeatureAdaption(cin, cin, device=device)
        # Conv3x3 + BN + ReLU + Conv3x3, the final bias init_bias
        self.cls_head = head_branch(cin, num_cls, 2, init_bias=init_bias,
                                    device=device)
        self.task_head = SepHead(cin, num_cls, with_hm=False, device=device)

    def forward(self, h: torch.Tensor) -> Dict[str, torch.Tensor]:
        """h (B, C, H, W) -> the branches' (B, H, W, c) maps, hm last."""
        x = h.permute(0, 2, 3, 1)
        cls_feat = self.feature_adapt_cls(x)
        reg_feat = self.feature_adapt_reg(x)
        out = self.task_head(reg_feat.permute(0, 3, 1, 2))
        out["hm"] = run_dense(self.cls_head,
                              cls_feat.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return out
