"""Row audit: the rows each level of a model needs for a batch, worked out
by the benchmark from the coordinates, against the port's fixed
capacities. The port drops rows past a capacity without a word, so a run
whose input would overflow a level stops here instead."""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Sequence

import torch

from ..reference import sparse as S


def seg_rows(coords: torch.Tensor, s: int, levels: int = 5) -> Dict:
    """ELKUNet: the rows of each stride level (kernel-2 stride-2 downs
    floor to multiples of 2^l) and the ELK aux cells of levels 1-4
    (floor(coords / (s * 2^l)))."""
    c = coords.to(torch.int64)
    rows, aux = [int(c.shape[0])], [None]
    for l in range(1, levels):
        d = c.clone()
        d[:, :3] = torch.div(d[:, :3], 1 << l, rounding_mode="floor") * (1 << l)
        c, _ = S.unique_rows(d)
        rows.append(int(c.shape[0]))
        a = c.clone()
        a[:, :3] = torch.div(a[:, :3], s * (1 << l), rounding_mode="floor")
        aux.append(int(S.unique_rows(a)[0].shape[0]))
    return {"rows": rows, "aux": aux}


def check_seg(per_batch: List[Dict], caps: Sequence[int],
              log: Callable[[str], None]) -> None:
    """Levels against `caps`; a level's aux cells against the next level's
    capacity (the model's aux capacities)."""
    worst = [max(b["rows"][l] for b in per_batch) for l in range(len(caps))]
    worst_aux = [None] + [max(b["aux"][l] for b in per_batch)
                          for l in range(1, len(caps))]
    log(f"row audit over {len(per_batch)} batches: most rows by level "
        f"{worst} against capacities {list(caps)}; most aux cells "
        f"{worst_aux[1:]} against {list(caps[1:])}")
    over = [l for l in range(len(caps)) if worst[l] > caps[l]]
    over_aux = [l for l in range(1, len(caps)) if worst_aux[l] > caps[l]]
    if over or over_aux:
        raise RuntimeError(f"rows would be dropped: levels {over}, aux "
                           f"levels {over_aux}")


def spconv_out(coords: torch.Tensor, k: Sequence[int], st: Sequence[int],
               pad: Sequence[int], shape: Sequence[int]):
    """The output set of a strided spconv (kernel k, stride st, padding
    pad) over (x, y, z, b) rows on a grid of `shape` (x, y, z): every cell
    that some input reaches through the kernel. Returns (coords, shape)."""
    c = coords.to(torch.int64)
    k, st, pad = (torch.tensor(v, device=c.device) for v in (k, st, pad))
    shp = torch.tensor(shape, device=c.device)
    out_shape = (shp + 2 * pad - k) // st + 1
    outs = []
    for kk in itertools.product(*(range(int(v)) for v in k)):
        num = c[:, :3] + pad - torch.tensor(kk, device=c.device)
        ok = (num % st == 0).all(1)
        o = num[ok] // st
        inb = ((o >= 0) & (o < out_shape)).all(1)
        outs.append(torch.cat([o[inb], c[ok][inb][:, 3:]], 1))
    u, _ = S.unique_rows(torch.cat(outs))
    return u, tuple(int(v) for v in out_shape)


DET_DOWNS = (((3, 3, 3), (2, 2, 2), (1, 1, 1)),
             ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
             ((3, 3, 3), (2, 2, 2), (1, 1, 0)))


def det_rows(coords: torch.Tensor, grid: Sequence[int]) -> List[int]:
    """CenterPoint's sparse backbone: the voxels, then the output set of
    each strided conv (levels 1-3), on the (x, y, z + 1) grid."""
    shape = (grid[0], grid[1], grid[2] + 1)
    rows = [int(coords.shape[0])]
    c = coords
    for k, st, pad in DET_DOWNS:
        c, shape = spconv_out(c, k, st, pad, shape)
        rows.append(int(c.shape[0]))
    return rows
