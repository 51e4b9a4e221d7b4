"""Detection sparse backbones: SpMiddleResNetFHDELKv3 and the plain
SpMiddleResNetFHD.

PyTorch counterpart of `link_tpu/models/scn.py` (reference
detection/det3d/models/backbones/scn.py:453-627). spconv ResNet: a
SubM stem (5 -> 16), 4 levels of 2 SparseBasicBlocks at planes
[16, 32, 64, 128] with SparseConv3d(k3, s2, p1) downsamples (z padding 0 at
the last), each level fused with a parallel TSELK block (cos basis, block
7, r 3) + SubM tail by add + ReLU, an extra z-compress SparseConv3d((3,1,1),
(2,1,1)), and .dense() -> (B, C*D, H, W) BEV. `elk=False` (and
`SpMiddleResNetFHD`) drops each level's ELK block, `elk{l}_tail` and
`conv{l}_tail`: CenterPoint's own VoxelNet backbone, the baseline LinK is
measured against.

`dense_from_level=L` runs the levels from L on (0-based, as in the JAX
package) on a masked dense grid (`sparse/dense_grid.py`): the rows of
level L are scattered into a DenseGrid after that level's strided down (at
L = 0 after the stem), and from there the submanifold convs, the strided
downs, the ELK blocks and the extra conv run as dense convolutions with the
same parameters, exact but for the capacity overflow the dense grid cannot
have; `dense_to_bev` gives the BEV map in `to_dense_bev`'s channel order.
None (the default) is fully sparse.

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
from ..sparse.dense_grid import (DenseGrid, dense_spconv, dense_subm_conv,
                                 dense_to_bev, to_dense_grid)
from ..sparse.spconv_engine import (ensure_level_table, spconv3d,
                                    spconv_out_shape, to_dense_bev)
from ..sparse.tensor import SparseTensor, make_sparse_tensor
from .elk import ELKBlock


def det_capacities(level0_per_frame: int, frames: int) -> Tuple[int, ...]:
    """The row capacities of the four backbone levels for a batch of
    `frames` frames of at most `level0_per_frame` voxels each:
    (c, c, c // 2, c // 4) with c = level0_per_frame * frames. A strided
    down's output set can hold as many rows as its input, and on 10-sweep
    frames of a driving ego level 1 reaches 0.96 of level 0, so level 1
    keeps level 0's capacity and each level above halves it. The ELK aux
    cells of a level take that level's capacity. Rows past a capacity are
    dropped and counted (`SpMiddleResNetFHDELKv3.rows_dropped`)."""
    c = int(level0_per_frame) * int(frames)
    return (c, c, c // 2, c // 4)


DET_CAPACITIES = det_capacities(163840, 1)
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
        if isinstance(st, DenseGrid):
            return dense_subm_conv(st, self.subm_kernel(), 3, self.bias)
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

    def forward(self, x: SparseTensor, in_shape, dropped=None):
        """`dropped`: a device counter the output rows past `out_capacity`
        are added to."""
        if isinstance(x, DenseGrid):
            y = dense_spconv(x, self[0].engine_kernel(), self.kernel_size,
                             self.stride, self.padding)
            out_shape = spconv_out_shape(in_shape, self.kernel_size,
                                         self.stride, self.padding)
        else:
            y, out_shape = spconv3d(x, self[0].engine_kernel(),
                                    self.kernel_size, in_shape,
                                    stride=self.stride, padding=self.padding,
                                    out_capacity=self.out_capacity,
                                    batch_size=self.batch_size,
                                    dropped=dropped)
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

    def __init__(self, num_input_features: int = 5, elk: bool = True,
                 block_sz: int = 7, elk_r: int = 3,
                 capacities: Tuple[int, ...] = DET_CAPACITIES,
                 batch_size: int = 1, dtype: str = "float32",
                 dense_from_level: Optional[int] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        if dense_from_level is not None and not 0 <= dense_from_level <= 3:
            raise ValueError("dense_from_level must be None or 0-3")
        self.elk = elk
        self.dense_from_level = dense_from_level
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
            if not elk:
                continue
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
        self._dropped: Optional[torch.Tensor] = None

    def _drop_counter(self, device) -> torch.Tensor:
        """The per-level count of rows dropped at a capacity, on `device`:
        made once (not a buffer, so no state_dict or replica collective
        sees it), then added to on the device without a sync."""
        if self._dropped is None or self._dropped.device != device:
            # a normal tensor even when made under inference_mode, so that
            # a later training step can add to it
            with torch.inference_mode(False):
                self._dropped = torch.zeros(4, dtype=torch.int64,
                                            device=device)
        return self._dropped

    def rows_dropped(self) -> Tuple[int, ...]:
        """Rows dropped by level since the model was made (or
        `reset_rows_dropped`): level l's strided down (l >= 1; the extra z
        conv at level 3) and its ELK aux cells past `capacities[l]`. Reads
        the device counter, so it waits for the device."""
        if self._dropped is None:
            return (0,) * 4
        return tuple(int(v) for v in self._dropped.tolist())

    def reset_rows_dropped(self) -> None:
        if self._dropped is not None:
            self._dropped.zero_()

    def forward(self, voxel_features: torch.Tensor, coords: torch.Tensor,
                nnz: torch.Tensor, input_shape: Tuple[int, int, int]):
        """input_shape = (W, H, D) grid extents, e.g. (1440, 1440, 40);
        coords (N, 4) (x, y, z, b) in pack-key order, as collate_det emits
        them. Returns the (B, C * D, H, W) BEV map."""
        shape = (input_shape[0], input_shape[1], input_shape[2] + 1)
        feats = voxel_features.to(self.dtype)
        dropped = self._drop_counter(feats.device)
        st = make_sparse_tensor(feats, coords, nnz=nnz, base_sorted=True,
                                device=feats.device)
        ensure_level_table(st, shape, self.batch_size)
        st = self.conv_input(st)
        for lvl in range(1, 5):
            if lvl > 1:
                st, shape = getattr(self, f"down{lvl}")(st, shape,
                                                        dropped[lvl - 1])
                if isinstance(st, SparseTensor):
                    ensure_level_table(st, shape, self.batch_size)
            # to the dense grid after level L's strided down, on the
            # level-L grid (lvl - 1 is the JAX package's 0-based level)
            if (self.dense_from_level is not None
                    and lvl - 1 >= self.dense_from_level
                    and isinstance(st, SparseTensor)):
                st = to_dense_grid(st, shape, self.batch_size)
            y = getattr(self, f"conv{lvl}")(st)
            if not self.elk:
                st = y
                continue
            y = getattr(self, f"conv{lvl}_tail")(y)
            lk = getattr(self, f"elk{lvl}")(st, self.block_sz, self.elk_r,
                                            dropped[lvl - 1])
            lk = getattr(self, f"elk{lvl}_tail")(lk)
            st = y.replace(feats=torch.relu(y.feats + lk.feats))
        st, shape = self.extra_conv(st, shape, dropped[3])
        if isinstance(st, DenseGrid):
            return dense_to_bev(st)
        return to_dense_bev(st, shape, self.batch_size)


class SpMiddleResNetFHD(SpMiddleResNetFHDELKv3):
    """The plain CenterPoint backbone, without the ELK branch (reference
    scn.py:155-264): level l is `conv{l}` alone. JAX's
    `SpMiddleResNetFHD`, the ELKv3 backbone with `elk=False`."""

    def __init__(self, num_input_features: int = 5, elk: bool = False,
                 **kw):
        super().__init__(num_input_features, elk=elk, **kw)
