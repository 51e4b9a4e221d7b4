"""Plain PyTorch sparse voxel operations for the references.

A sparse tensor here holds only its real rows: integer coordinates
(N, 4) int64 as (x, y, z, batch) on the lattice of its stride, and
features (N, C). Neighbours are found by packing coordinates into one
int64 key and a binary search over the sorted keys; a conv is a sum over
its taps of a row gather and a matrix product, scattered with
`index_add`. Autograd differentiates all of it.

`Precision` rounds the operands of every matrix product, for the lower
precision control: "tf32" keeps 10 mantissa bits (what a TF32 tensor core
reads), "fp8" scales each operand to float8 e4m3's range and rounds it
there (per-tensor scaling, as fp8 inference does); "exact" leaves them.
"""

from __future__ import annotations

from typing import Optional

import torch

_SHIFT = 1 << 12          # coordinates from -2^12 up to 2^16 - 2^12


def pack(coords: torch.Tensor) -> torch.Tensor:
    """int64 key of (x, y, z, b) rows (batch below 2^15)."""
    c = coords.to(torch.int64)
    xyz = c[:, :3] + _SHIFT
    return ((c[:, 3] * (1 << 16) + xyz[:, 2]) * (1 << 16) + xyz[:, 1]) * (
        1 << 16) + xyz[:, 0]


class Lookup:
    """Row index of a coordinate in a set of rows, or -1."""

    def __init__(self, coords: torch.Tensor):
        keys = pack(coords)
        self.sorted, self.order = torch.sort(keys)

    def __call__(self, query: torch.Tensor) -> torch.Tensor:
        q = pack(query)
        pos = torch.searchsorted(self.sorted, q).clamp(max=self.sorted.numel()
                                                       - 1)
        hit = self.sorted[pos] == q
        return torch.where(hit, self.order[pos], torch.full_like(pos, -1))


def unique_rows(coords: torch.Tensor):
    """(unique coords, inverse index of each row)."""
    keys = pack(coords)
    uk, inv = torch.unique(keys, return_inverse=True)
    first = torch.full((uk.numel(),), coords.shape[0], dtype=torch.int64,
                       device=coords.device)
    first.scatter_reduce_(0, inv, torch.arange(coords.shape[0],
                                               device=coords.device), "amin")
    return coords[first], inv


class Precision:
    def __init__(self, mode: str = "exact"):
        if mode not in ("exact", "tf32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def round(self, t: torch.Tensor) -> torch.Tensor:
        """The operand as the lower precision reads it, in float32; the
        rounding passes the gradient straight through."""
        if self.mode == "exact":
            return t
        t32 = t.float()
        if self.mode == "tf32":
            bits = t32.detach().view(torch.int32)
            # round to nearest on the 13 dropped mantissa bits
            bits = (bits + 0x1000) & ~0x1FFF
            q = bits.view(torch.float32)
        else:
            amax = t32.detach().abs().amax().clamp(min=1e-30)
            scale = 448.0 / amax
            q = (t32.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        return t32 + (q - t32).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)


EXACT = Precision("exact")


def kernel_offsets(size, stride: int = 1) -> torch.Tensor:
    """Tap offsets in the port's weight layout (torchsparse's): odd kernel
    volumes z-major (x fastest), even ones x-major (z fastest); offsets
    -k//2+1 .. k//2 per axis times the input stride."""
    sx, sy, sz = (size,) * 3 if isinstance(size, int) else size
    axes = [torch.arange(-s // 2 + 1, s // 2 + 1) * stride for s in (sx, sy, sz)]
    if (sx * sy * sz) % 2 == 1:
        offs = [(x, y, z) for z in axes[2] for y in axes[1] for x in axes[0]]
    else:
        offs = [(x, y, z) for x in axes[0] for y in axes[1] for z in axes[2]]
    return torch.tensor([[int(v) for v in o] for o in offs], dtype=torch.int64)


def conv_pairs(in_coords: torch.Tensor, out_coords: torch.Tensor,
               offsets: torch.Tensor, lookup: Optional[Lookup] = None):
    """Per tap k, (input rows, output rows) with in = out + offsets[k]."""
    lookup = lookup or Lookup(in_coords)
    dev = out_coords.device
    pairs = []
    for o in offsets.to(dev):
        q = out_coords.clone()
        q[:, :3] += o
        idx = lookup(q)
        j = torch.nonzero(idx >= 0).squeeze(1)
        pairs.append((idx[j], j))
    return pairs


def apply_pairs(feats: torch.Tensor, weight: torch.Tensor, pairs, n_out: int,
                prec: Precision = EXACT, transposed: bool = False):
    """sum_k feats[in_k] @ W[k] scattered to out_k (transposed: the pairs'
    roles swapped)."""
    out = feats.new_zeros((n_out, weight.shape[-1]))
    for k, (i, j) in enumerate(pairs):
        src, dst = (j, i) if transposed else (i, j)
        if src.numel() == 0:
            continue
        out = out.index_add(0, dst, prec.mm(feats.index_select(0, src),
                                            weight[k]))
    return out


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    """BatchNorm1d in training mode: biased variance over the rows."""
    mean = x.mean(0)
    var = x.var(0, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias
