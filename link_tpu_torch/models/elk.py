"""ELK block: linear large-kernel aggregation via trig reparameterization.

PyTorch counterpart of `link_tpu/models/elk.py` (reference
segmentation/core/models/semantic_kitti/linkunet.py:94-185), over a
SparseTensor or, at the det backbone's dense levels, a DenseGrid. The
position-dependent kernel weight is reparameterized in the
{sin, cos, cos_x} bases, so the large-window conv factorizes into per-voxel
modulation -> block pre-aggregation -> r^3 window sum -> per-voxel
demodulation. On a SparseTensor the aggregation is `elk_aggregate` over the
block's plan (`ops/elk.py`: gather-form kernels forward and backward, any
r), unless the dense-aux gate (odd r, a bounded grid) takes
`elk_aux_window_dense`.

`det_grouping=True` reproduces the detection TSELKBlock's channel grouping:
the positional Linear has full width (3, inc) but only its first inc/2
columns are used, tiled twice. `normalize_coords=True` is the encoder-only
model's variant (reference linkencoder.py:165): under the cos_x basis the
positional map reads coords / stride.

On a DenseGrid the cells' grid coordinates stand in for the rows' coords,
the LayerNorm'd input is re-zeroed at the empty cells, and the aggregation
collapses to block sums and an r^3 box sum over the block grid,
weighted by the occupied cells per block (`sparse/dense_grid.py`).

The block is rematerializable (`nn/remat.py`), as the seg models' ELK
blocks are under `remat=True`. Under a profiler the block runs inside the
range `ELK_FWD` and its backward inside `ELK_BWD` (`utils/profiling.py`),
the replay of a rematerialized block included; its convs' and plans'
ranges nest inside.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn import remat
from ..nn.modules import Linear, SparseConv3d, SparseLayerNorm
from ..ops.elk import (elk_aggregate, elk_aux_plan, elk_aux_window_dense,
                       use_dense_aux)
from ..sparse.dense_grid import (DenseGrid, block_broadcast, block_pool,
                                 box_sum, cell_coords_xyz)
from ..sparse.tensor import SparseTensor
from ..utils.profiling import ELK_BWD, ELK_FWD, BackwardSpan, span


class ELKBlock(nn.Module):

    def __init__(self, inc: int, aux_capacity: int, groups: int = 1,
                 baseop: str = "cos_x", normalize_coords: bool = False,
                 det_grouping: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if baseop not in ("cos", "sin", "cos_x"):
            raise ValueError(f"unknown ELK basis {baseop!r}")
        if inc % groups:
            raise ValueError("inc must be divisible by groups")
        self.inc = inc
        self.aux_capacity = aux_capacity
        self.groups = groups
        self.baseop = baseop
        self.normalize_coords = normalize_coords
        self.det_grouping = det_grouping
        cg = inc if det_grouping else inc // groups
        self.pre_mix = nn.Sequential(
            Linear(inc, inc, bias=False, device=device, generator=generator),
            SparseLayerNorm(inc, device=device))
        self.local_mix = nn.Sequential(
            SparseConv3d(inc, inc, 3, device=device, generator=generator))
        self.pos_weight = nn.Sequential(
            Linear(3, cg, bias=False, device=device, generator=generator))
        if baseop == "cos_x" and not det_grouping:
            self.alpha = nn.Parameter(torch.ones(1, cg, device=device))
        else:
            self.alpha = None
        self.norm = SparseLayerNorm(inc, device=device)
        self.norm_local = SparseLayerNorm(inc, device=device)

    def forward(self, st: SparseTensor, s: int, r: int,
                dropped: Optional[torch.Tensor] = None) -> SparseTensor:
        """`dropped`: a device counter the aux cells past `aux_capacity`
        are added to (the sparse aux path's only drop)."""
        with span(ELK_FWD):
            bwd = BackwardSpan(ELK_BWD, st.feats)
            if not bwd.on:
                return self._block(st, s, r, dropped)
            out = self._block(st.replace(feats=bwd.x), s, r, dropped)
            return out.replace(feats=bwd.out(out.feats))

    @remat.rematerializable
    def _block(self, st: SparseTensor, s: int, r: int,
               dropped: Optional[torch.Tensor] = None) -> SparseTensor:
        dense = isinstance(st, DenseGrid)
        f_input = self.pre_mix(st.feats)
        if dense:
            # empty cells must add nothing to the block pooling; the
            # LayerNorm's bias made them nonzero
            f_input = torch.where(st.mask[..., None], f_input,
                                  torch.zeros_like(f_input))
        local = self.local_mix(st)

        if dense:
            if self.normalize_coords:
                raise ValueError("normalize_coords has no dense form")
            c3 = cell_coords_xyz(st)        # (Z, Y, X, 3), broadcast over B
        else:
            c3 = st.coords[:, :3].to(torch.float32)
            if self.baseop == "cos_x" and self.normalize_coords:
                c3 = c3 / st.stride[0]
        pw = self.pos_weight(c3)
        if self.det_grouping:
            half = pw[..., :self.inc // 2]
            pw = torch.cat([half, half], dim=-1)
        elif self.baseop == "cos_x":
            pw = pw * self.alpha
        else:
            pw = torch.cat([pw] * self.groups, dim=-1)
        pw_sin, pw_cos = torch.sin(pw), torch.cos(pw)

        if self.baseop == "sin":
            mod = torch.cat([f_input * pw_sin, f_input * pw_cos], dim=-1)
        elif self.baseop == "cos":
            mod = torch.cat([f_input * pw_cos, f_input * pw_sin], dim=-1)
        else:  # cos_x
            f_lin = f_input * pw
            mod = torch.cat([f_input * pw_cos, f_input * pw_sin, f_lin], dim=-1)
        # the f32 trig factors promote mod; the aux pooling moves model-dtype
        # rows and sums in f32
        mod = mod.to(st.feats.dtype)

        gs = None if dense else use_dense_aux(st, s, r, mod.shape[-1])
        if dense:
            _, z, y, x, _ = st.feats.shape
            sums, counts = block_pool(mod, st.mask, s)
            mean = sums / torch.clamp(counts, min=1.0)[..., None]
            f = torch.cat([mean, torch.ones_like(counts)[..., None]], dim=-1)
            win = box_sum(f * counts[..., None], r)
            denom = win[..., -1:]
            blocks = win[..., :-1] / torch.where(denom == 0,
                                                 torch.ones_like(denom), denom)
            agg = block_broadcast(blocks, s, (z, y, x)).to(st.feats.dtype)
        elif gs is not None:
            agg = elk_aux_window_dense(mod, st.coords, s, r, gs)
        else:
            plan = elk_aux_plan(st, s, r, self.aux_capacity,
                                inverse=torch.is_grad_enabled()
                                and mod.requires_grad, dropped=dropped)
            agg = elk_aggregate(mod, plan)

        c = self.inc
        if self.baseop == "sin":
            new = agg[..., :c] * pw_cos - agg[..., c:] * pw_sin
        elif self.baseop == "cos":
            new = agg[..., :c] * pw_cos + agg[..., c:] * pw_sin
        else:
            # cos(a - b) + linear term, self-tap subtracted
            new = (agg[..., :c] * pw_cos + agg[..., c:2 * c] * pw_sin
                   + (agg[..., 2 * c:] - f_lin))

        new = self.norm(new)
        local_f = self.norm_local(local.feats)
        out = torch.relu(new + local_f)
        return st.masked(out) if dense else st.replace(feats=out)
