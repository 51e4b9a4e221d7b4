"""LinK encoder-only segmentation model (reference linkencoder.py:188-389,
ELKEncoder).

PyTorch counterpart of `link_tpu/models/linkencoder.py`, inference path.
The same stem and 4-level ELK encoder as ELKUNet (`ELKSegEncoder`), but no
transposed-conv decoder: every level is broadcast back to the stem's coords
with `upsample_voxel` (nearest-ancestor join), the 5 scales are concatenated
along channels and classified by a grouped 1x1 conv head (groups=5) -> 120
-> classes (linkencoder.py:323-328). The ELK blocks' cos_x positional map
reads coords / stride (linkencoder.py:165). The reference also defines the
decoder `up1`-`up4`, which its forward never calls; the port leaves them
out, and `utils.convert.load_reference_state_dict` drops their keys by name
(`UNUSED_REFERENCE_KEYS`).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.elk import upsample_voxel
from ..sparse.tensor import SparseTensor
from .linkunet import DEFAULT_CAPACITIES, ELKSegEncoder


class GroupedPointConv(nn.Module):
    """1x1 grouped Conv1d over per-voxel features, in torch Conv1d's layout
    (weight (Co, Ci / groups, 1), bias (Co,)) and default init bound
    1/sqrt(Ci / groups). The product runs per group in float32 and is cast
    to the feature dtype, as the JAX model's einsum does."""

    def __init__(self, in_features: int, out_features: int, groups: int = 1,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if in_features % groups or out_features % groups:
            raise ValueError("features must be divisible by groups")
        self.groups = groups
        ci = in_features // groups
        bound = 1.0 / math.sqrt(ci)
        w = torch.empty((out_features, ci, 1)).uniform_(-bound, bound,
                                                        generator=generator)
        b = torch.empty((out_features,)).uniform_(-bound, bound,
                                                  generator=generator)
        self.weight = nn.Parameter(w.to(device))
        self.bias = nn.Parameter(b.to(device))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        g = self.groups
        co, ci = self.weight.shape[:2]
        x = feats.to(torch.float32).reshape(feats.shape[0], g, ci)
        w = self.weight[:, :, 0].reshape(g, co // g, ci)
        y = torch.einsum("ngi,goi->ngo", x, w) + self.bias.reshape(g, co // g)
        return y.reshape(feats.shape[0], co).to(feats.dtype)


class ELKEncoder(ELKSegEncoder):
    UNUSED_REFERENCE_KEYS = ("up1.", "up2.", "up3.", "up4.")

    def __init__(self, num_classes: int, cr: float = 1.0, r: int = 3,
                 s: int = 7, groups: int = 2, baseop: str = "cos",
                 in_channels: int = 4,
                 capacities: Tuple[int, ...] = DEFAULT_CAPACITIES,
                 aux_capacities: Optional[Tuple[int, ...]] = None,
                 dtype: str = "float32",
                 grid_extent: Optional[Tuple[int, int, int, int]] = None,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__(cr, r, s, groups, baseop, in_channels, capacities,
                         aux_capacities, dtype, grid_extent,
                         normalize_coords=True, device=device,
                         generator=generator)
        kw = dict(device=device, generator=generator)
        self.classifier = nn.Sequential(
            GroupedPointConv(self.cs[8] * 5, 120, groups=5, **kw),
            nn.ReLU(),
            GroupedPointConv(120, num_classes, groups=1, **kw))

    def forward(self, x: SparseTensor) -> torch.Tensor:
        x0, x1, x2, x3, x4 = self.encode(x)
        fs = [upsample_voxel(xl, x0).feats for xl in (x4, x3, x2, x1)]
        fs.append(x0.feats)
        # under bfloat16 the levels are float32 (the ELK output promotes)
        # and the stem's output is not: the concat takes the wider type,
        # as jnp.concatenate does
        dt = functools.reduce(torch.promote_types, [f.dtype for f in fs])
        f_cat = torch.cat([f.to(dt) for f in fs], dim=1)
        return self.classifier(f_cat)
