"""ELK pre-aggregation ops: voxel <-> aux-block transforms.

PyTorch counterpart of `link_tpu/ops/elk.py`:
  * voxel_to_aux: coarsen coords by s, dedup, mean-pool voxel feats into
    aux blocks;
  * aux_to_voxel: count-weighted mean over each aux cell's r^3 window of
    aux cells, broadcast back to the voxels. The window's self-join runs
    through `join_taps` (the `sorted_join` kernel); the window sum is
    a plain gather-sum;
  * elk_aux_window_dense: the same result on a dense aux grid (odd r only),
    gated by use_dense_aux;
  * upsample_voxel: broadcast a coarse level's feats onto finer coords
    through each fine voxel's ancestor, one exact join (`sorted_join`).

Inside a rematerialized ELK block (`nn/remat.py`) the aux cells, the
window's join and the float32 scatter sums are kept for the block's replay,
which then joins nothing and rounds nothing otherwise than the forward.
Under a profiler each of these index builds (aux cells, the window's join
and its inverse, the upsample's table and query, the dense grid's cell
index) runs inside the range `PLAN`.
"""

from __future__ import annotations

import torch

from ..nn import remat
from ..sparse import coords as coordlib
from ..sparse import ops as spops
from ..sparse.conv import mirror_perm
from ..sparse.dense_grid import box_sum
from ..sparse.tensor import SparseTensor
from ..utils.profiling import PLAN, span

# Dense-aux path budget: bytes of the f32 (cells, C+1) aux grid.
DENSE_AUX_MAX_BYTES = 256 * 1024 * 1024


def aux_grid_shape(x: SparseTensor, s: int):
    """RAW-extent (nx, ny, nz, nb) bound of x's coord domain, from
    grid_extent (seg) or the level table's lattice extent (det levels,
    spconv_engine.ensure_level_table), or None."""
    if x.grid_extent is not None:
        return tuple(int(v) for v in x.grid_extent)
    ltab = x.kmaps.get(("table", x.stride))
    if ltab is not None and ltab.grid is not None:
        return ltab.grid
    return None


def use_dense_aux(x: SparseTensor, s: int, r: int, channels: int):
    """Gate + grid shape for the dense-aux path (odd r, bounded domain,
    grid within DENSE_AUX_MAX_BYTES)."""
    if r % 2 != 1:
        return None
    gs = aux_grid_shape(x, s)
    if gs is None:
        return None
    nxr, nyr, nzr, nb = (int(v) for v in gs)
    cells = nb * (-(-nxr // s)) * (-(-nyr // s)) * (-(-nzr // s))
    if cells * (channels + 1) * 4 > DENSE_AUX_MAX_BYTES:
        return None
    return gs


def elk_aux_window_dense(mod: torch.Tensor, coords: torch.Tensor, s: int,
                         r: int, grid_shape) -> torch.Tensor:
    """Fused voxel_to_aux + aux_to_voxel on a dense aux grid: scatter-add
    the feats and an occupancy count into the s^3-block grid, take the
    centered r^3 box sum, and gather each voxel's result by its cell."""
    if r % 2 != 1:
        raise ValueError("dense aux window requires odd r")
    nxr, nyr, nzr, nb = (int(v) for v in grid_shape)
    nxa, nya, nza = -(-nxr // s), -(-nyr // s), -(-nzr // s)
    cells = nb * nza * nya * nxa
    c = mod.shape[1]
    with span(PLAN):
        x, y, z, b = (coords[:, 0], coords[:, 1], coords[:, 2],
                      coords[:, 3])
        valid = ((x >= 0) & (x < nxr) & (y >= 0) & (y < nyr)
                 & (z >= 0) & (z < nzr) & (b >= 0) & (b < nb))
        lin = (((b.long() * nza + z // s) * nya + y // s) * nxa + x // s)
        lin = torch.where(valid, lin, torch.full_like(lin, cells))
        cnts = torch.zeros(cells + 1, dtype=torch.float32, device=mod.device)
        cnts.index_add_(0, lin, valid.to(torch.float32))
    sums = spops.segment_sum(torch.where(valid[:, None],
                                         mod.to(torch.float32), 0.0),
                             lin, cells + 1)
    grid = sums[:cells].reshape(nb, nza, nya, nxa, c)
    cgrid = cnts[:cells].reshape(nb, nza, nya, nxa, 1)
    win = box_sum(grid, r)
    wc = box_sum(cgrid, r)[..., 0]
    new = win / torch.where(wc == 0, torch.ones_like(wc), wc)[..., None]
    flat = torch.cat([new.reshape(cells, c), new.new_zeros((1, c))])
    return flat.index_select(0, lin).to(mod.dtype)      # see spdevoxelize


def _div_coords(coords: torch.Tensor, s: int) -> torch.Tensor:
    """(x, y, z) // s with the batch column kept; sentinel rows unchanged."""
    xyz = coords[:, :3]
    is_pad = coords[:, :1] <= coordlib.INVALID_COORD
    div = torch.where(is_pad, xyz, torch.div(xyz, s, rounding_mode="floor"))
    return torch.cat([div, coords[:, 3:]], dim=1)


def voxel_to_aux(x: SparseTensor, s: int, aux_capacity: int):
    """Pool voxels into s^3 aux blocks.

    Returns (aux, idx_query, counts): aux cells keyed by the divided coords
    (floor(coord / s), batch); voxel -> aux slot (-1 for padding rows);
    voxels per aux cell."""
    def plan():
        with span(PLAN):
            aux_coords, idx_query, aux_nnz = coordlib.unique_coords(
                _div_coords(x.coords, s), aux_capacity)
            return (aux_coords, idx_query, aux_nnz,
                    spops.spcount(idx_query, aux_capacity))

    # a plan: a rematerialized block's replay reads it back (nn/remat.py)
    aux_coords, idx_query, aux_nnz, counts = remat.saved(plan)
    aux_feats = spops.spvoxelize(x.feats, idx_query, counts)
    aux = SparseTensor(feats=aux_feats, coords=aux_coords, nnz=aux_nnz,
                       stride=(s, s, s), cmaps=x.cmaps, kmaps=x.kmaps,
                       base_sorted=x.base_sorted, coords_sorted=True)
    return aux, idx_query, counts


def aux_to_voxel(aux: SparseTensor, x: SparseTensor, idx_query: torch.Tensor,
                 counts: torch.Tensor, r: int = 2) -> SparseTensor:
    """Sum features over the r^3 window of aux cells around each aux cell,
    weighted by voxel counts, renormalize by the window's total count, and
    broadcast back to the voxels of `x`. The count channel is appended as an
    all-ones feature, as the reference does."""
    offsets = coordlib.kernel_offsets_np((r, r, r), stride=1, dilation=1)
    # aux coords come from unique_coords, so they are already in key order;
    # the join is a plan, which a rematerialized block's replay reads back
    def window():
        with span(PLAN):
            return coordlib.join_taps(
                coordlib.build_table(aux.coords, assume_sorted=True),
                aux.coords, offsets)

    nb_idx = remat.saved(window).T                        # (M_aux, r^3)

    f = torch.cat([aux.feats, aux.feats.new_ones((aux.capacity, 1))], dim=1)
    f = f * counts.to(aux.feats.dtype)[:, None]
    # The window sum is a self-join over the offsets; where they are
    # symmetric (odd r) its inverse map is the same index with the taps
    # mirrored, and the backward gathers over it. Even windows have no
    # mirror and are differentiated by autograd.
    inv_nb = None
    if torch.is_grad_enabled() and f.requires_grad:
        mir = mirror_perm(offsets)
        if mir is not None:
            with span(PLAN):
                inv_nb = nb_idx[:, torch.tensor(mir, device=nb_idx.device)]
    window = spops.spdevoxelize(f, nb_idx,
                                torch.ones_like(nb_idx, dtype=f.dtype),
                                inv_idx=inv_nb)
    denom = window[:, -1:]
    new_feat = window[:, :-1] / torch.where(denom == 0,
                                            torch.ones_like(denom), denom)

    safe = torch.where(idx_query >= 0, idx_query,
                       torch.full_like(idx_query, new_feat.shape[0])).long()
    ext = torch.cat([new_feat, new_feat.new_zeros((1, new_feat.shape[1]))])
    return x.replace(feats=ext.index_select(0, safe))   # see spdevoxelize


def upsample_voxel(x: SparseTensor, ref_x: SparseTensor) -> SparseTensor:
    """Nearest-ancestor broadcast of coarse feats onto fine coords
    (utils.py:327-340): both coord sets divided by the coarse stride, one
    exact join of the divided fine rows against the divided coarse table,
    and a gather with a zero row for misses. The result carries ref_x's
    coords and coord maps."""
    s = x.stride[0]
    # the coarse coords are multiples of s, so dividing them keeps key order
    # and the table skips its sort when they were sorted; the fine side's
    # division can invert the order across z / y boundaries, which the
    # join takes as it comes
    with span(PLAN):
        with span(coordlib.JOIN_INPUT_RANGE):
            coarse = _div_coords(x.coords, s)
            fine = _div_coords(ref_x.coords, s)
        table = coordlib.build_table(coarse, assume_sorted=x.coords_sorted)
        idx = table.query(fine)
    n = x.capacity
    safe = torch.where(idx >= 0, idx, torch.full_like(idx, n)).long()
    ext = torch.cat([x.feats, x.feats.new_zeros((1, x.feats.shape[1]))])
    return ref_x.replace(feats=ext.index_select(0, safe))
