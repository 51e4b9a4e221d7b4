"""Dense-grid helpers (the part of `link_tpu/sparse/dense_grid.py` that the
ELK block's dense aux path uses)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
