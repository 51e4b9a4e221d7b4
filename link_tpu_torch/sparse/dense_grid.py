"""Dense-grid execution of sparse-conv semantics (the det backbone's hybrid
levels).

PyTorch counterpart of `link_tpu/sparse/dense_grid.py`. At the det
backbone's deeper levels the occupancy is high enough that a masked dense
convolution can stand in for the sparse one, exactly:

  * submanifold conv == mask * (dense_conv(feats) + bias): empty cells hold
    exact zeros, so they add nothing to any tap sum, and the output mask is
    the input mask;
  * strided spconv == out_mask * (dense_conv(feats) + bias) with out_mask[j]
    the OR over the kernel window of in_mask[j * s - p + t] (a max-pool):
    spconv's output-site rule without the fixed-capacity overflow clipping;
  * ELK aux ops == block-sum pooling + r^3 box sums over the block grid.

Layout: feats (B, Z, Y, X, C), mask (B, Z, Y, X), pack-key major, so
`to_dense_grid` is one scatter of the rows and the BEV view (B, C * D, H,
W) a permute and reshape. The convs run `F.conv3d` on the channels-last
view (B, C, Z, Y, X) of the same memory; they are plain convolutions, as
the JAX package leaves them to `lax.conv_general_dilated`. Weights come in
the sparse layout (K, Ci, Co) and are permuted to the dense kernel's tap
positions. A float32 conv sums in float32; a bfloat16 one rounds its
output to bfloat16 before the float32 bias is added (JAX adds the bias to
the float32 sum, then rounds).

Invariant kept by every op here: feats == 0 at every cell whose mask is
False.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import coords as coordlib


@dataclass
class DenseGrid:
    """Dense voxel grid with an occupancy mask: feats (B, Z, Y, X, C), zero
    at unoccupied cells; mask (B, Z, Y, X) bool."""

    feats: torch.Tensor
    mask: torch.Tensor

    def replace(self, **kw) -> "DenseGrid":
        return dataclasses.replace(self, **kw)

    def masked(self, feats: torch.Tensor) -> "DenseGrid":
        """Replace feats, re-zeroing the unoccupied cells."""
        return self.replace(feats=torch.where(self.mask[..., None], feats,
                                              torch.zeros_like(feats)))


def to_dense_grid(st, spatial_shape: Tuple[int, int, int],
                  batch_size: int) -> DenseGrid:
    """Scatter a SparseTensor's rows into a DenseGrid, in the flat order of
    `spconv_engine.to_dense_bev` ((b, z, y, x)-major). Every valid row is a
    distinct cell; rows outside the grid and padding go to a dump cell that
    is cut off."""
    w, h, d = (int(v) for v in spatial_shape)
    c = st.feats.shape[1]
    xx, yy, zz, bb = (st.coords[:, i].long() for i in range(4))
    valid = ((xx >= 0) & (xx < w) & (yy >= 0) & (yy < h) & (zz >= 0)
             & (zz < d) & (bb >= 0) & (bb < batch_size))
    cells = batch_size * d * h * w
    flat = torch.where(valid, ((bb * d + zz) * h + yy) * w + xx,
                       torch.full_like(xx, cells))
    vals = torch.where(valid[:, None], st.feats, torch.zeros_like(st.feats))
    dense = st.feats.new_zeros((cells + 1, c)).index_copy(0, flat, vals)
    mask = torch.zeros(cells + 1, dtype=torch.bool, device=st.feats.device)
    mask[flat] = valid
    return DenseGrid(feats=dense[:-1].reshape(batch_size, d, h, w, c),
                     mask=mask[:-1].reshape(batch_size, d, h, w))


def dense_to_bev(g: DenseGrid) -> torch.Tensor:
    """(B, C * D, H, W) with C outer, the channel order of
    `spconv_engine.to_dense_bev`."""
    b, d, h, w, c = g.feats.shape
    return g.feats.permute(0, 4, 1, 2, 3).reshape(b, c * d, h, w)


def _perm_to_dense(offsets_xyz: np.ndarray, ks: Tuple[int, int, int]):
    """Permutation placing tap k of a (K, Ci, Co) weight at its (dz, dy, dx)
    position in the dense (kz, ky, kx) kernel; offsets are [x, y, z] rows,
    position = offset - min offset per axis."""
    kx, ky, kz = ks
    mins = offsets_xyz.min(axis=0)
    perm = np.zeros(kx * ky * kz, np.int64)
    for k, (ox, oy, oz) in enumerate(offsets_xyz):
        dx, dy, dz = (int(ox - mins[0]), int(oy - mins[1]),
                      int(oz - mins[2]))
        perm[(dz * ky + dy) * kx + dx] = k
    return perm


def _dense_kernel(weight: torch.Tensor, perm: np.ndarray, ks) -> torch.Tensor:
    """(K, Ci, Co) taps -> the conv3d weight (Co, Ci, kz, ky, kx) in the
    channels-last layout of the features, so that cuDNN convolves NDHWC
    without transposing either."""
    kx, ky, kz = ks
    ci, co = weight.shape[1], weight.shape[2]
    idx = torch.as_tensor(perm, device=weight.device)
    w = weight.index_select(0, idx).reshape(kz, ky, kx, ci, co)
    return w.permute(4, 0, 1, 2, 3).contiguous().permute(0, 4, 1, 2, 3)


def _conv(feats: torch.Tensor, kernel: torch.Tensor, stride, pad,
          bias: Optional[torch.Tensor]) -> torch.Tensor:
    """conv3d over (B, Z, Y, X, C) with per-axis (lo, hi) padding `pad` in
    (z, y, x) order; returns (B, Z', Y', X', Co) in float32 with the bias
    added."""
    x = feats.permute(0, 4, 1, 2, 3)                # channels-last view
    if all(lo == hi for lo, hi in pad):
        out = F.conv3d(x, kernel.to(feats.dtype), None, stride,
                       tuple(lo for lo, _ in pad))
    else:
        flat = [v for lo_hi in reversed(pad) for v in lo_hi]   # x first
        out = F.conv3d(F.pad(x, flat), kernel.to(feats.dtype), None, stride)
    out = out.permute(0, 2, 3, 4, 1).to(torch.float32)
    return out if bias is None else out + bias


def dense_subm_conv(g: DenseGrid, weight: torch.Tensor, kernel_size,
                    bias: Optional[torch.Tensor] = None) -> DenseGrid:
    """Submanifold conv: out[j] = sum_k W_k f[j + off_k] at occupied j, zero
    elsewhere; taps in `coords.kernel_offsets_np` order (the sparse weight
    layout). A 2-D weight is the 1x1x1 conv."""
    dt = g.feats.dtype
    if weight.dim() == 2:
        out = g.feats.to(torch.float32) @ weight.to(dt).to(torch.float32)
        if bias is not None:
            out = out + bias
        return g.masked(out.to(dt))
    ks = coordlib.make_ntuple(kernel_size)
    offs = coordlib.kernel_offsets_np(ks, stride=1, dilation=1)
    mins = offs.min(axis=0)
    # padding per axis = -min offset, so out[p] reads in[p + off]
    pad = [(int(-mins[a]), int(ks[a] - 1 + mins[a])) for a in (2, 1, 0)]
    out = _conv(g.feats, _dense_kernel(weight, _perm_to_dense(offs, ks), ks),
                (1, 1, 1), pad, bias)
    return g.masked(out.to(dt))


def dense_spconv(g: DenseGrid, weight: torch.Tensor, kernel_size, stride,
                 padding, bias: Optional[torch.Tensor] = None) -> DenseGrid:
    """Strided spconv: out[j] = sum_t W_t f[j * s - p + t]; an output cell is
    occupied iff an input in its window is (`spconv_engine` semantics, taps
    in its x-major, z-fastest order)."""
    ks = coordlib.make_ntuple(kernel_size)
    s = coordlib.make_ntuple(stride)
    p = coordlib.make_ntuple(padding)
    kx, ky, kz = ks
    taps = np.asarray([[tx, ty, tz] for tx in range(kx) for ty in range(ky)
                       for tz in range(kz)], np.int32)
    strides = (s[2], s[1], s[0])
    pads = (p[2], p[1], p[0])
    out = _conv(g.feats, _dense_kernel(weight, _perm_to_dense(taps, ks), ks),
                strides, [(v, v) for v in pads], bias)
    # the window-OR of the input mask; max_pool3d's padding never wins
    out_mask = F.max_pool3d(g.mask[:, None].to(torch.float32), (kz, ky, kx),
                            strides, pads)[:, 0] > 0
    out = torch.where(out_mask[..., None], out, torch.zeros_like(out))
    return DenseGrid(feats=out.to(g.feats.dtype), mask=out_mask)


def cell_coords_xyz(g: DenseGrid) -> torch.Tensor:
    """(Z, Y, X, 3) float32 map of each cell's (x, y, z) grid coordinate:
    the dense stand-in for st.coords[:, :3] in the ELK positional branch."""
    _, z, y, x, _ = g.feats.shape
    dev = g.feats.device
    zz, yy, xx = torch.meshgrid(
        torch.arange(z, dtype=torch.float32, device=dev),
        torch.arange(y, dtype=torch.float32, device=dev),
        torch.arange(x, dtype=torch.float32, device=dev), indexing="ij")
    return torch.stack([xx, yy, zz], dim=-1)


def block_pool(feats: torch.Tensor, mask: torch.Tensor, s: int):
    """voxel_to_aux on the grid: the float32 sum of feats and the count of
    occupied cells per s^3 block, Z / Y / X padded up to multiples of s with
    empty cells. Returns (sums (B, Zb, Yb, Xb, C), counts (B, Zb, Yb, Xb))."""
    b, z, y, x, c = feats.shape
    pz, py, px = (-z) % s, (-y) % s, (-x) % s
    f = F.pad(feats.to(torch.float32), (0, 0, 0, px, 0, py, 0, pz))
    m = F.pad(mask.to(torch.float32), (0, px, 0, py, 0, pz))
    zb, yb, xb = (z + pz) // s, (y + py) // s, (x + px) // s
    f = f.reshape(b, zb, s, yb, s, xb, s, c).sum(dim=(2, 4, 6))
    m = m.reshape(b, zb, s, yb, s, xb, s).sum(dim=(2, 4, 6))
    return f, m


def box_sum(x: torch.Tensor, r: int) -> torch.Tensor:
    """Centered r^3 window sum over the (B, Z, Y, X, C) block grid, zero
    outside, in float32 (odd r, matching kernel_offsets_np's centered
    enumeration). Summed one axis at a time."""
    if r % 2 != 1:
        raise ValueError("dense ELK box window requires odd r")
    h = r // 2
    out = x.to(torch.float32)
    for axis in (1, 2, 3):
        size = out.shape[axis]
        pad = [0, 0] * (4 - axis) + [h, h]      # F.pad pads last dims first
        padded = F.pad(out, pad)
        out = sum(padded.narrow(axis, d, size) for d in range(r))
    return out


def block_broadcast(blocks: torch.Tensor, s: int,
                    spatial: Tuple[int, int, int]) -> torch.Tensor:
    """Per-block values back to their cells (aux_to_voxel's gather), the
    padding cropped: (B, Zb, Yb, Xb, C) -> (B, Z, Y, X, C)."""
    z, y, x = spatial
    out = blocks
    for axis in (1, 2, 3):
        out = out.repeat_interleave(s, dim=axis)
    return out[:, :z, :y, :x]
