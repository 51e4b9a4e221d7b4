"""Voxel and pillar feature readers besides VoxelFeatureExtractorV3.

PyTorch counterpart of `link_tpu/models/readers.py` (reference
detection/det3d/models/readers/{pillar_encoder.py,
dynamic_voxel_encoder.py}): PillarFeatureNet with its PFN layers and the
PointPillarsScatter BEV map, and the dynamic (scatter-mean) voxel encoder.
Plain modules: the registry that names them for a config waits for
`utils/registry` (ROADMAP §1 item 7). Parameter names follow the
reference (`pfn_layers.<i>.linear.weight`, `pfn_layers.<i>.norm.*`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..nn.modules import Linear, SparseBatchNorm
from ..sparse import coords as coordlib
from ..sparse import ops as spops
from ..sparse.tensor import SparseTensor


class PFNLayer(nn.Module):
    """pillar_encoder.py:15-55: Linear -> BN over the real points -> ReLU ->
    max over the pillar's points (concatenated back onto each point unless
    it is the last layer)."""

    def __init__(self, in_channels: int, out_channels: int,
                 last_layer: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.last_layer = last_layer
        units = out_channels if last_layer else out_channels // 2
        self.linear = Linear(in_channels, units, bias=False, device=device,
                             generator=generator)
        self.norm = SparseBatchNorm(units, eps=1e-3, momentum=0.01,
                                    device=device)

    def forward(self, x: torch.Tensor, point_mask: torch.Tensor
                ) -> torch.Tensor:
        h = self.linear(x)
        n, p, c = h.shape
        # the masked BN of the sparse rows: padding points are rows with
        # invalid coords
        rows = torch.where(point_mask.reshape(-1, 1),
                           torch.zeros((n * p, 4), dtype=torch.int32,
                                       device=h.device),
                           torch.full((n * p, 4), coordlib.INVALID_COORD,
                                      dtype=torch.int32, device=h.device))
        st = SparseTensor(feats=h.reshape(n * p, c), coords=rows,
                          nnz=point_mask.sum().to(torch.int32))
        h = torch.relu(self.norm(st).feats.reshape(n, p, c))
        h = torch.where(point_mask[..., None], h, torch.zeros_like(h))
        h_max = h.amax(dim=1, keepdim=True)
        if self.last_layer:
            return h_max
        return torch.cat([h, h_max.expand_as(h)], dim=-1)


class PillarFeatureNet(nn.Module):
    """pillar_encoder.py:59-160: points decorated with their offsets from
    the pillar's mean and from the pillar's centre (and, with
    `with_distance`, their range), PFN layers, one feature per pillar."""

    def __init__(self, num_input_features: int = 5,
                 num_filters: Sequence[int] = (64,),
                 with_distance: bool = False,
                 voxel_size: Tuple[float, float] = (0.2, 0.2),
                 pc_range: Tuple[float, float] = (-54.0, -54.0), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.with_distance = with_distance
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        dims = [num_input_features + 5 + int(with_distance)] \
            + list(num_filters)
        self.pfn_layers = nn.ModuleList([
            PFNLayer(dims[i], dims[i + 1], last_layer=i == len(dims) - 2,
                     device=device, generator=generator)
            for i in range(len(dims) - 1)])

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor,
                coords: torch.Tensor) -> torch.Tensor:
        """voxels (N, P, F); coords (N, 4) = (x, y, z, b) grid indices ->
        (N, C)."""
        n, p, _ = voxels.shape
        point_mask = (torch.arange(p, device=voxels.device)[None, :]
                      < num_points.clamp(min=0)[:, None])
        denom = num_points.clamp(min=1).to(voxels.dtype)[:, None, None]
        xyz = voxels[..., :3]
        mean = torch.where(point_mask[..., None], xyz,
                           torch.zeros_like(xyz)).sum(1, keepdim=True) / denom
        f_cluster = xyz - mean
        vx, vy = self.voxel_size
        cx = coords[:, 0].to(voxels.dtype) * vx + vx / 2 + self.pc_range[0]
        cy = coords[:, 1].to(voxels.dtype) * vy + vy / 2 + self.pc_range[1]
        f_center = torch.stack([voxels[..., 0] - cx[:, None],
                                voxels[..., 1] - cy[:, None]], dim=-1)
        feats = [voxels, f_cluster, f_center]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True))
        h = torch.cat(feats, dim=-1)
        h = torch.where(point_mask[..., None], h, torch.zeros_like(h))
        for layer in self.pfn_layers:
            h = layer(h, point_mask)
        return h[:, 0, :]


def point_pillars_scatter(feats: torch.Tensor, coords: torch.Tensor,
                          nnz, grid_hw: Tuple[int, int],
                          batch_size: int) -> torch.Tensor:
    """Pillar features into a dense (B, C, H, W) BEV map
    (pillar_encoder.py:163-220); rows at or past nnz and outside the grid
    are dropped."""
    w, h = grid_hw
    c = feats.shape[1]
    xx, yy, bb = (coords[:, i].long() for i in (0, 1, 3))
    row = torch.arange(feats.shape[0], device=feats.device)
    valid = ((row < nnz) & (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
             & (bb >= 0) & (bb < batch_size))
    cells = batch_size * h * w
    flat = torch.where(valid, (bb * h + yy) * w + xx,
                       torch.full_like(xx, cells))
    vals = torch.where(valid[:, None], feats, torch.zeros_like(feats))
    dense = feats.new_zeros((cells + 1, c)).index_copy(0, flat, vals)
    return dense[:-1].reshape(batch_size, h, w, c).permute(0, 3, 1, 2)


def dynamic_voxel_encoder(points: torch.Tensor, valid: torch.Tensor,
                          voxel_size, pc_range, grid, capacity: int):
    """Scatter-mean dynamic voxelization (dynamic_voxel_encoder.py:8-83): no
    per-voxel point cap. Returns (feats, coords, nnz) at `capacity`."""
    vs = torch.as_tensor(voxel_size, dtype=points.dtype, device=points.device)
    pr = torch.as_tensor(pc_range[:3], dtype=points.dtype,
                         device=points.device)
    g = torch.as_tensor(grid, dtype=torch.int32, device=points.device)
    c = torch.floor((points[:, :3] - pr) / vs).to(torch.int32)
    ok = valid & ((c >= 0) & (c < g)).all(dim=1)
    c4 = torch.cat([torch.where(ok[:, None], c,
                                torch.full_like(c, coordlib.INVALID_COORD)),
                    torch.zeros((len(points), 1), dtype=torch.int32,
                                device=points.device)], dim=1)
    out_coords, inverse, out_nnz = coordlib.unique_coords(c4, capacity)
    counts = spops.spcount(inverse, capacity)
    return spops.spvoxelize(points, inverse, counts), out_coords, out_nnz
