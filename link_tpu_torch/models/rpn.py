"""RPN neck: dense BEV conv pyramid.

PyTorch counterpart of `link_tpu/models/rpn.py` (reference
detection/det3d/models/necks/rpn.py:22-160), with the reference's module
layout and `state_dict` keys: `blocks[i]` = [ZeroPad2d(1), Conv3x3(stride
s_i, no bias), BN, ReLU] + layer_num x [Conv3x3(pad 1), BN, ReLU];
`deblocks[i]` = [ConvTranspose(k = s = us_stride) or a k = s conv when
us_stride <= 1, BN, ReLU]; the upsampled branches are channel-concatenated.
The dense 2-D convs stay PyTorch convolutions, as `link_tpu` leaves them
to XLA.

`dtype` is the compute dtype: convs run in it (weights cast, parameters
stay float32; in float64 the caller keeps float64 parameters) and BatchNorm
normalizes in float32, or float64, and rounds back.

BatchNorm in training normalizes with the batch statistics, as torch does,
and moves its running statistics as flax `nn.BatchNorm` moves JAX's: by the
biased batch variance E[x^2] - E[x]^2, where torch's `F.batch_norm` takes
the unbiased one (`batch_norm_2d`). Reference det3d trains with torch's
update; both packages differ from it there.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

RPN_NORM = dict(eps=1e-3, momentum=0.01)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}


def batch_norm_2d(mod: nn.BatchNorm2d, h: torch.Tensor) -> torch.Tensor:
    """`mod` over NCHW `h` in float32 (float64 stays float64). Eval mode
    reads the running statistics; training normalizes with the batch's
    and moves the running ones by `mod.momentum` towards the batch mean and
    the biased batch variance (flax's update)."""
    x = h.to(torch.promote_types(h.dtype, torch.float32))
    if not mod.training:
        return F.batch_norm(x, mod.running_mean, mod.running_var, mod.weight,
                            mod.bias, False, 0.0, mod.eps)
    with torch.no_grad():
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp_min(x.square().mean(dim=(0, 2, 3)) - mean.square(),
                              0.0)
        for buf, batch in ((mod.running_mean, mean), (mod.running_var, var)):
            buf.mul_(1 - mod.momentum).add_(mod.momentum * batch.to(buf.dtype))
        mod.num_batches_tracked.add_(1)
    return F.batch_norm(x, None, None, mod.weight, mod.bias, True, 0.0,
                        mod.eps)


def run_dense(seq: nn.Sequential, h: torch.Tensor) -> torch.Tensor:
    """Apply a Sequential of ZeroPad2d / Conv2d / ConvTranspose2d /
    BatchNorm2d / ReLU in the dtype of `h`: conv weights and biases are
    cast to it, BatchNorm runs in float32 (`batch_norm_2d`) and rounds
    back."""
    dt = h.dtype
    for mod in seq:
        if isinstance(mod, nn.Conv2d):
            bias = None if mod.bias is None else mod.bias.to(dt)
            h = F.conv2d(h, mod.weight.to(dt), bias, mod.stride, mod.padding)
        elif isinstance(mod, nn.ConvTranspose2d):
            bias = None if mod.bias is None else mod.bias.to(dt)
            h = F.conv_transpose2d(h, mod.weight.to(dt), bias, mod.stride,
                                   mod.padding)
        elif isinstance(mod, nn.BatchNorm2d):
            h = batch_norm_2d(mod, h).to(dt)
        else:
            h = mod(h)
    return h


class RPN(nn.Module):

    def __init__(self, layer_nums: Sequence[int] = (5, 5),
                 ds_layer_strides: Sequence[int] = (1, 2),
                 ds_num_filters: Sequence[int] = (128, 256),
                 us_layer_strides: Sequence[float] = (1, 2),
                 us_num_filters: Sequence[int] = (256, 256),
                 num_input_features: int = 256, dtype: str = "float32",
                 device="cuda"):
        super().__init__()
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        self.dtype = _DTYPES[dtype]
        kw = dict(device=device)
        self.blocks = nn.ModuleList()
        self.deblocks = nn.ModuleList()
        start = len(layer_nums) - len(us_layer_strides)
        cin = num_input_features
        for i, n_layers in enumerate(layer_nums):
            f = ds_num_filters[i]
            layers = [nn.ZeroPad2d(1),
                      nn.Conv2d(cin, f, 3, stride=ds_layer_strides[i],
                                bias=False, **kw),
                      nn.BatchNorm2d(f, **RPN_NORM, **kw), nn.ReLU()]
            for _ in range(n_layers):
                layers += [nn.Conv2d(f, f, 3, padding=1, bias=False, **kw),
                           nn.BatchNorm2d(f, **RPN_NORM, **kw), nn.ReLU()]
            self.blocks.append(nn.Sequential(*layers))
            if i - start >= 0:
                us = us_layer_strides[i - start]
                fo = us_num_filters[i - start]
                if us > 1:
                    up = nn.ConvTranspose2d(f, fo, int(us), stride=int(us),
                                            bias=False, **kw)
                else:
                    s = int(round(1 / us))
                    up = nn.Conv2d(f, fo, s, stride=s, bias=False, **kw)
                self.deblocks.append(nn.Sequential(
                    up, nn.BatchNorm2d(fo, **RPN_NORM, **kw), nn.ReLU()))
            cin = f
        self.start = start

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) BEV -> (B, sum(us_filters), H', W')."""
        h = x.to(self.dtype)
        ups = []
        for i, block in enumerate(self.blocks):
            h = run_dense(block, h)
            if i - self.start >= 0:
                ups.append(run_dense(self.deblocks[i - self.start], h))
        return torch.cat(ups, dim=1) if ups else h
