"""Detection sparse backbone: SpMiddleResNetFHDELKv3.

PyTorch counterpart of `link_tpu/models/scn.py` (reference
detection/det3d/models/backbones/scn.py:453-627), fully sparse (the
DenseGrid hybrid of `dense_from_level` is not ported). spconv ResNet: a
SubM stem (5 -> 16), 4 levels of 2 SparseBasicBlocks at planes
[16, 32, 64, 128] with SparseConv3d(k3, s2, p1) downsamples (z padding 0 at
the last), each level fused with a parallel TSELK block (cos basis, block
7, r 3) + SubM tail by add + ReLU, an extra z-compress SparseConv3d((3,1,1),
(2,1,1)), and .dense() -> (B, C*D, H, W) BEV.

Parameters carry the reference det3d `state_dict` keys and layouts
(`conv_input.0.weight` (Co, kz, ky, kx, Ci), `conv1.0.conv1.bias`,
`down2.1.running_mean`, `elk1.local_mix.0.kernel`, ...), so a reference
backbone dict loads directly. Spatial shapes are (x, y, z) = (W, H, D).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..nn.modules import SparseBatchNorm, SparseReLU, _uniform
from ..sparse import conv as spconv
from ..sparse.spconv_engine import ensure_level_table, spconv3d, to_dense_bev
from ..sparse.tensor import SparseTensor, make_sparse_tensor
from .elk import ELKBlock

DET_CAPACITIES = (163840, 81920, 40960, 20480)
DET_NORM = dict(eps=1e-3, momentum=0.01)
PLANES = (16, 32, 64, 128)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SpconvWeight(nn.Module):
    """A spconv conv's parameters in the reference layout: `weight`
    (Co, kz, ky, kx, Ci) and an optional `bias` (Co,), with the reference's
    uniform 1/sqrt(Ci * K) init."""

    def __init__(self, inc: int, outc: int, kernel_size: Tuple[int, int, int],
                 bias: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kx, ky, kz = kernel_size
        std = 1.0 / math.sqrt(inc * kx * ky * kz)
        self.weight = _uniform((outc, kz, ky, kx, inc), std, generator, device)
        self.bias = _uniform((outc,), std, generator, device) if bias else None

    def subm_kernel(self) -> torch.Tensor:
        """(K, Ci, Co) in the submanifold tap order (offsets -1..1, z-major,
        x fastest; link_tpu/utils/torch_import_det.py:spconv_subm_to_ts)."""
        co, kz, ky, kx, ci = self.weight.shape
        return self.weight.permute(1, 2, 3, 4, 0).reshape(kz * ky * kx, ci, co)

    def engine_kernel(self) -> torch.Tensor:
        """(K, Ci, Co) in the strided-engine tap order (x-major, z fastest;
        torch_import_det.py:spconv_strided_to_engine)."""
        co, kz, ky, kx, ci = self.weight.shape
        return self.weight.permute(3, 2, 1, 4, 0).reshape(kz * ky * kx, ci, co)


class SubMConv3d(SpconvWeight):
    """spconv SubMConv3d(k=3), run as a submanifold conv that prefers the
    window form (scn.py: prefer_window=True)."""

    def __init__(self, inc: int, outc: int, bias: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(inc, outc, (3, 3, 3), bias=bias, device=device,
                         generator=generator)

    def forward(self, st: SparseTensor) -> SparseTensor:
        return spconv.conv3d(st, self.subm_kernel(), 3, bias=self.bias,
                             prefer_window=True)


class SpConvDown(nn.Sequential):
    """SparseConv3d(k, s, p) + BN + ReLU (`<name>.0.weight`, `<name>.1.*`)."""

    def __init__(self, inc: int, outc: int, kernel_size, stride, padding,
                 out_capacity: int, batch_size: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(
            SpconvWeight(inc, outc, kernel_size, device=device,
                         generator=generator),
            SparseBatchNorm(outc, device=device, **DET_NORM))
        self.kernel_size = tuple(kernel_size)
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.out_capacity = out_capacity
        self.batch_size = batch_size

    def forward(self, x: SparseTensor, in_shape):
        y, out_shape = spconv3d(x, self[0].engine_kernel(), self.kernel_size,
                                in_shape, stride=self.stride,
                                padding=self.padding,
                                out_capacity=self.out_capacity,
                                batch_size=self.batch_size)
        y = self[1](y)
        return y.replace(feats=torch.relu(y.feats)), out_shape


class SparseBasicBlock(nn.Module):
    """scn.py:62-106: SubM(3, bias) + BN + ReLU + SubM(3, bias) + BN +
    identity + ReLU."""

    def __init__(self, planes: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = SubMConv3d(planes, planes, bias=True, **kw)
        self.bn1 = SparseBatchNorm(planes, device=device, **DET_NORM)
        self.conv2 = SubMConv3d(planes, planes, bias=True, **kw)
        self.bn2 = SparseBatchNorm(planes, device=device, **DET_NORM)

    def forward(self, x: SparseTensor) -> SparseTensor:
        y = self.bn1(self.conv1(x))
        y = y.replace(feats=torch.relu(y.feats))
        y = self.bn2(self.conv2(y))
        return y.replace(feats=torch.relu(y.feats + x.feats))


class SpMiddleResNetFHDELKv3(nn.Module):

    def __init__(self, num_input_features: int = 5, block_sz: int = 7,
                 elk_r: int = 3, capacities: Tuple[int, ...] = DET_CAPACITIES,
                 batch_size: int = 1, dtype: str = "float32", device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        self.block_sz, self.elk_r = block_sz, elk_r
        self.capacities = tuple(capacities)
        self.batch_size = batch_size
        self.dtype = _DTYPES[dtype]
        kw = dict(device=device, generator=generator)
        p = PLANES
        self.conv_input = nn.Sequential(
            SubMConv3d(num_input_features, p[0], **kw),
            SparseBatchNorm(p[0], device=device, **DET_NORM), SparseReLU())
        for lvl in range(4):
            c = p[lvl]
            if lvl > 0:
                zpad = 1 if lvl < 3 else 0
                self.add_module(f"down{lvl + 1}", SpConvDown(
                    p[lvl - 1], c, (3, 3, 3), (2, 2, 2), (1, 1, zpad),
                    out_capacity=self.capacities[lvl], batch_size=batch_size,
                    **kw))
            self.add_module(f"conv{lvl + 1}", nn.Sequential(
                SparseBasicBlock(c, **kw), SparseBasicBlock(c, **kw)))
            self.add_module(f"conv{lvl + 1}_tail", nn.Sequential(
                SubMConv3d(c, c, **kw),
                SparseBatchNorm(c, device=device, **DET_NORM)))
            self.add_module(f"elk{lvl + 1}", ELKBlock(
                c, aux_capacity=self.capacities[lvl], baseop="cos",
                det_grouping=True, **kw))
            self.add_module(f"elk{lvl + 1}_tail", nn.Sequential(
                SubMConv3d(c, c, **kw),
                SparseBatchNorm(c, device=device, **DET_NORM)))
        self.extra_conv = SpConvDown(p[3], p[3], (1, 1, 3), (1, 1, 2),
                                     (0, 0, 0),
                                     out_capacity=self.capacities[3],
                                     batch_size=batch_size, **kw)

    def forward(self, voxel_features: torch.Tensor, coords: torch.Tensor,
                nnz: torch.Tensor, input_shape: Tuple[int, int, int]):
        """input_shape = (W, H, D) grid extents, e.g. (1440, 1440, 40);
        coords (N, 4) (x, y, z, b) in pack-key order, as collate_det emits
        them. Returns the (B, C * D, H, W) BEV map."""
        shape = (input_shape[0], input_shape[1], input_shape[2] + 1)
        feats = voxel_features.to(self.dtype)
        st = make_sparse_tensor(feats, coords, nnz=nnz, base_sorted=True,
                                device=feats.device)
        ensure_level_table(st, shape, self.batch_size)
        st = self.conv_input(st)
        for lvl in range(1, 5):
            if lvl > 1:
                st, shape = getattr(self, f"down{lvl}")(st, shape)
                ensure_level_table(st, shape, self.batch_size)
            y = getattr(self, f"conv{lvl}")(st)
            y = getattr(self, f"conv{lvl}_tail")(y)
            lk = getattr(self, f"elk{lvl}")(st, self.block_sz, self.elk_r)
            lk = getattr(self, f"elk{lvl}_tail")(lk)
            st = y.replace(feats=torch.relu(y.feats + lk.feats))
        st, shape = self.extra_conv(st, shape)
        return to_dense_bev(st, shape, self.batch_size)
