"""Sparse 3D convolution: kernel-map planning + gather-matmul.

PyTorch counterpart of `link_tpu/sparse/conv.py`. A plan holds a dense
gather-form kernel map `in_idx[K, M_out]` over the fixed output capacity:

    forward:    y[j] = sum_k feats[in_idx[k, j]] @ W[k]     (miss -> 0)
    transposed: y[i] = sum_k feats[inv_idx[k, i]] @ W[k]

Both run through the hand-written `gather_conv` kernel; when a gradient
is needed they run through `GatherConv`, whose backward is the same kernel
over the inverse map (feature gradient) and the `gather_wgrad` kernel
(weight gradient), as `_gm` of the JAX package. A submanifold
conv over sorted input rows whose caller prefers the window form gives
its plan the window arrays (base_pos, slot, groups) and runs through the
hand-written `window_conv` kernel when a whole G-row window is narrow
enough (`window_chunk`, as `link_tpu` decides); when a gradient is needed
it runs through `WindowConv`, whose feature gradient is the same kernel
over the plan's own windows with mirrored, transposed weights and whose
weight gradient is `gather_wgrad` over the mirrored map, as
`_gm_win_factory` of the JAX package. Every plan's join runs
through the `sorted_join` kernel (`link_tpu_torch/ops/kernels.py`), one
call per plan: the window arrays come from the same call when the first
conv to build the plan prefers the window form. Inside a rematerialized
block (`nn/remat.py`) both Functions tape their output for the block's
replay, as the JAX convs tag theirs `CONV_OUT_TAG`.

Under a profiler the conv kernels run inside the range of their role
(`CONV_FWD`, `CONV_DGRAD`, `CONV_WGRAD` of `utils/profiling.py`) and every
kernel-map build (plan, inverse map, work list) inside `PLAN`; no range of
the one kind holds the other. The 1x1x1 products are dense matmuls and
stay outside both.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..nn import remat
from ..ops import kernels
from ..utils.profiling import CONV_DGRAD, CONV_FWD, CONV_WGRAD, PLAN, span
from . import coords as coordlib
from . import ops as spops
from .tensor import ConvPlan, SparseTensor


def mirror_perm(offsets: np.ndarray):
    """Static tap permutation m with offsets[m[k]] == -offsets[k], or None
    if the offset set is not symmetric (even kernels / strided taps)."""
    offs = np.asarray(offsets)
    lut = {tuple(o): i for i, o in enumerate(offs.tolist())}
    perm = []
    for o in offs.tolist():
        j = lut.get((-o[0], -o[1], -o[2]))
        if j is None:
            return None
        perm.append(j)
    return tuple(perm)


def build_conv_plan(in_coords: torch.Tensor, out_coords: torch.Tensor,
                    out_nnz: torch.Tensor, offsets, in_capacity: int,
                    in_sorted: bool = False,
                    table: Optional[coordlib.CoordTable] = None,
                    window_quantum: Optional[int] = None) -> ConvPlan:
    """Kernel map: for each output row and tap, the input row at
    out_coord + offset (or -1). One join over all K * M queries. With
    `window_quantum` (a submanifold plan that takes the window form, see
    `add_window_form`) the same join also gives the window arrays."""
    if table is None:
        table = coordlib.build_table(in_coords, assume_sorted=in_sorted)
    offs_np = np.asarray(offsets)
    mir = mirror_perm(offs_np) if out_coords is in_coords else None
    if window_quantum is not None:
        in_idx, base_pos, slot = coordlib.window_join(table, out_coords,
                                                      offs_np)
        return _with_window(ConvPlan(in_idx=in_idx, out_coords=out_coords,
                                     out_nnz=out_nnz,
                                     in_capacity=in_capacity, mirror=mir),
                            base_pos, slot, offs_np, window_quantum)
    in_idx = coordlib.join_taps(table, out_coords, offs_np)
    return ConvPlan(in_idx=in_idx, out_coords=out_coords, out_nnz=out_nnz,
                    in_capacity=in_capacity, mirror=mir)


def _with_window(plan: ConvPlan, base_pos: torch.Tensor, slot: torch.Tensor,
                 offs_np: np.ndarray, quantum: int) -> ConvPlan:
    glist = coordlib.offset_groups(offs_np)
    groups = tuple(tuple(t for _, t in taps) for _, taps in glist)
    self_gi = next((gi for gi, ((ox0, oy, oz), _) in enumerate(glist)
                    if oy == 0 and oz == 0 and ox0 in (0, -quantum)), None)
    return plan.replace(base_pos=base_pos, slot=slot, groups=groups,
                        self_group=self_gi)


def add_window_form(plan: ConvPlan, table: coordlib.CoordTable, offsets,
                    quantum: int) -> ConvPlan:
    """The plan with its window form (base_pos, slot, groups, self_group;
    link_tpu/sparse/conv.py:111-145). For a submanifold plan over input
    rows in pack-key order (`table` with the identity perm) whose taps
    form x-runs with the step `quantum` of the rows' x lattice. One
    `window_join` (its in_idx equals the plan's)."""
    offs_np = np.asarray(offsets)
    _, base_pos, slot = coordlib.window_join(table, plan.out_coords, offs_np)
    return _with_window(plan, base_pos, slot, offs_np, quantum)


def invert_plan(plan: ConvPlan) -> torch.Tensor:
    """Inverse kernel map: inv[k, i] = output row j with in_idx[k, j] == i
    (or -1). Well-defined because j -> in_idx[k, j] is injective per tap."""
    k, m = plan.in_idx.shape
    n = plan.in_capacity
    dev = plan.in_idx.device
    tgt = torch.where(plan.in_idx >= 0, plan.in_idx,
                      torch.full_like(plan.in_idx, n)).long()
    inv = torch.full((k, n + 1), -1, dtype=torch.int32, device=dev)
    src = torch.arange(m, dtype=torch.int32, device=dev).expand(k, m)
    # valid targets are unique per tap; misses all land in the dump column
    inv.scatter_(1, tgt, src)
    return inv[:, :n].contiguous()


def window_chunk(g: int, c: int, itemsize: int) -> int:
    """Rows of a window that `link_tpu` fetches in one <= 256 B gather
    (link_tpu/sparse/conv.py:351-356); the window form runs when a whole
    G-row window fits (chunk >= G), i.e. C * itemsize * G <= 256 B."""
    return max(1, min(g, 256 // (c * itemsize)))


def uses_window(plan: ConvPlan, feats: torch.Tensor,
                prefer_window: bool) -> bool:
    """Whether apply_conv_plan takes the window form for these feats: a
    caller that prefers it (the "auto" rule of `_window_pref`,
    link_tpu/sparse/conv.py:61-64: the det backbone opts in, seg does not),
    a window plan with a mirror (submanifold), and a whole window that fits
    one chunk (link_tpu/sparse/conv.py:674-687)."""
    if (not prefer_window or plan.base_pos is None or plan.mirror is None
            or plan.window == 0):
        return False
    c = feats.shape[1]
    return window_chunk(plan.window, c, feats.element_size()) >= plan.window


_mirror_tables = {}


def _mirror_index(mirror: Tuple[int, ...], device) -> torch.Tensor:
    """The tap permutation as an int64 tensor on `device`, cached per
    (mirror, device) so that a backward copies nothing from the host."""
    key = (mirror, str(device))
    idx = _mirror_tables.get(key)
    if idx is None:
        idx = _mirror_tables[key] = torch.tensor(mirror, device=device)
    return idx


def plan_bwd_idx(plan: ConvPlan) -> torch.Tensor:
    """Inverse of the plan's forward map, (K, N_in): bwd_idx[k, i] == j iff
    in_idx[k, j] == i. A submanifold plan's is its own map with the taps
    mirrored; any other plan's is `inv_idx` (`invert_plan`). Computed once
    and kept on the plan (link_tpu/sparse/conv.py:691-697 recomputes it per
    apply, which costs nothing under jit)."""
    if plan.bwd_idx is None:
        with span(PLAN):
            if plan.mirror is not None:
                plan.bwd_idx = plan.in_idx[_mirror_index(plan.mirror,
                                                         plan.in_idx.device)]
            else:
                if plan.inv_idx is None:
                    plan.inv_idx = invert_plan(plan)
                plan.bwd_idx = plan.inv_idx
    return plan.bwd_idx


def plan_wgrad_work(plan: ConvPlan, transposed: bool = False):
    """The weight-gradient work list (`kernels.wgrad_work_list`) of the
    map the conv's backward gathers over: `plan_bwd_idx(plan)`, or for the
    transposed conv `in_idx`. Built once and kept on the plan, so the
    weight gradients of every conv that shares the plan reuse it."""
    if transposed:
        if plan.in_work is None:
            with span(PLAN):
                plan.in_work = kernels.wgrad_work_list(plan.in_idx)
        return plan.in_work
    if plan.bwd_work is None:
        bwd_idx = plan_bwd_idx(plan)
        with span(PLAN):
            plan.bwd_work = kernels.wgrad_work_list(bwd_idx)
    return plan.bwd_work


def _conv_fwd(fn, *args):
    """A conv kernel of a forward, inside `CONV_FWD`."""
    with span(CONV_FWD):
        return fn(*args)


class GatherConv(torch.autograd.Function):
    """The gather-matmul conv with a gather-form backward
    (link_tpu/sparse/conv.py:568-625, `_gm`):

        out[j]     = sum_k feats[idx[k, j]] @ W[k]
        d_feats[i] = sum_k g[bwd_idx[k, i]] @ W[k]^T     (`gather_conv`)
        d_W[k]     = sum_i feats[i]^T (x) g[bwd_idx[k, i]] (`gather_wgrad`)

    with `bwd_idx` the inverse of `idx` and `work` its weight-gradient work
    list (`plan_wgrad_work`; built in the backward when None). d_feats comes
    back in the feature dtype and d_W in the weight's; both sums are
    float32."""

    @staticmethod
    def forward(ctx, feats, weight, idx, bwd_idx, work=None):
        ctx.save_for_backward(feats, weight, bwd_idx)
        ctx.work = work
        # taped for a rematerialized block's replay (nn/remat.py)
        return remat.saved(lambda: _conv_fwd(kernels.gather_conv, feats,
                                             idx, weight), conv_output=True)

    @staticmethod
    def backward(ctx, g):
        feats, weight, bwd_idx = ctx.saved_tensors
        g = g.contiguous()
        d_feats = d_weight = None
        if ctx.needs_input_grad[0]:
            with span(CONV_DGRAD):
                d_feats = kernels.gather_conv(
                    g, bwd_idx, weight.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            work = ctx.work
            if work is None:
                with span(PLAN):
                    work = kernels.wgrad_work_list(bwd_idx)
            with span(CONV_WGRAD):
                d_weight = kernels.gather_wgrad(feats, g, bwd_idx,
                                                work).to(weight.dtype)
        return d_feats, d_weight, None, None, None


class WindowConv(torch.autograd.Function):
    """The window-form conv of a submanifold plan with a mirror, with its
    backward (link_tpu/sparse/conv.py:488-535, `_gm_win_factory`):

        out     = window_conv(feats, base_pos, slot, groups, W)
        d_feats = window_conv(g, base_pos, slot, groups, W[mirror]^T)
        d_W[k]  = sum_i feats[i]^T (x) g[in_idx[mirror[k], i]]   (gather_wgrad)

    The feature gradient reads g through the plan's own windows: output
    and input rows are one set, and tap t's inverse is tap mirror[t]. It is
    skipped when feats need no gradient (the stem reads the voxel means).
    Where Ci != Co and feats need a gradient, a whole window of the
    Co-wide g must fit one chunk (`window_chunk`), as `uses_window`
    requires of feats; where it does not, the conv raises rather than take
    another form for the backward."""

    @staticmethod
    def forward(ctx, feats, weight, plan):
        ci, co = weight.shape[1], weight.shape[2]
        if (ctx.needs_input_grad[0] and ci != co and window_chunk(
                plan.window, co, feats.element_size()) < plan.window):
            raise ValueError(
                f"WindowConv: a window of {plan.window} rows of the "
                f"{co}-channel gradient exceeds one chunk, so its feature "
                "gradient cannot take the window form")
        ctx.save_for_backward(feats, weight)
        ctx.plan = plan
        return remat.saved(lambda: _conv_fwd(
            kernels.window_conv, feats, plan.base_pos, plan.slot,
            plan.groups, weight), conv_output=True)

    @staticmethod
    def backward(ctx, g):
        feats, weight = ctx.saved_tensors
        plan = ctx.plan
        g = g.contiguous()
        d_feats = d_weight = None
        if ctx.needs_input_grad[0]:
            with span(CONV_DGRAD):
                mir = _mirror_index(plan.mirror, weight.device)
                d_feats = kernels.window_conv(
                    g, plan.base_pos, plan.slot, plan.groups,
                    weight[mir].transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            bwd_idx, work = plan_bwd_idx(plan), plan_wgrad_work(plan)
            with span(CONV_WGRAD):
                d_weight = kernels.gather_wgrad(feats, g, bwd_idx,
                                                work).to(weight.dtype)
        return d_feats, d_weight, None


def apply_conv_plan(feats: torch.Tensor, weight: torch.Tensor,
                    plan: ConvPlan, transposed: bool = False,
                    prefer_window: bool = False) -> torch.Tensor:
    """Execute the plan through `window_conv` (window form, see
    `uses_window`) or `gather_conv`. `weight` is (K, Ci, Co). The
    transposed conv gathers over the plan's inverse map, so feats live on
    the plan's output side and the result on its input side. When autograd
    needs a gradient of feats or weight, the gather form runs through
    `GatherConv` and the window form through `WindowConv`: the form is the
    same in training as in inference, as in the JAX package."""
    needs_grad = torch.is_grad_enabled() and (feats.requires_grad
                                              or weight.requires_grad)
    if transposed:
        if plan.inv_idx is None:
            raise ValueError("transposed apply needs plan.inv_idx "
                             "(invert_plan)")
        if needs_grad:
            return GatherConv.apply(feats, weight, plan.inv_idx, plan.in_idx,
                                    plan_wgrad_work(plan, transposed=True))
        return _conv_fwd(kernels.gather_conv, feats, plan.inv_idx, weight)
    if uses_window(plan, feats, prefer_window):
        if needs_grad:
            return WindowConv.apply(feats, weight, plan)
        return _conv_fwd(kernels.window_conv, feats, plan.base_pos,
                         plan.slot, plan.groups, weight)
    if needs_grad:
        return GatherConv.apply(feats, weight, plan.in_idx,
                                plan_bwd_idx(plan), plan_wgrad_work(plan))
    return _conv_fwd(kernels.gather_conv, feats, plan.in_idx, weight)


def _level_plan(x: SparseTensor, plan: Optional[ConvPlan], kernel_size,
                stride, offsets, window_q: Optional[int],
                out_capacity: Optional[int]) -> ConvPlan:
    """The plan of a forward conv3d over `x`: built (with the level's key
    table, shared by every plan at this level, and for a strided conv the
    downsampled coords and the eager inverse map of the U-Net's matching
    transposed conv), or, a plan first built for a caller that did not
    prefer the window form, given its window arrays."""
    if plan is not None:
        return add_window_form(plan, x.kmaps[("table", x.stride)], offsets,
                               window_q)
    strided = any(s > 1 for s in stride)
    if strided:
        out_coords, out_nnz = spops.spdownsample(
            x.coords, out_capacity or x.capacity, stride, kernel_size,
            x.stride)
    else:
        out_coords, out_nnz = x.coords, x.nnz
    tkey = ("table", x.stride)
    table = x.kmaps.get(tkey)
    if table is None:
        iso = x.stride[0] == x.stride[1] == x.stride[2]
        table = coordlib.build_table(
            x.coords, assume_sorted=x.coords_sorted,
            grid_shape=x.grid_extent if iso else None,
            grid_quantum=x.stride[0])
        x.kmaps[tkey] = table
    plan = build_conv_plan(x.coords, out_coords, out_nnz, offsets,
                           in_capacity=x.capacity, in_sorted=x.coords_sorted,
                           table=table, window_quantum=window_q)
    if strided and plan.mirror is None:
        plan = plan.replace(inv_idx=invert_plan(plan))
    return plan


def conv3d(x: SparseTensor, weight: torch.Tensor,
           kernel_size: Union[int, Tuple[int, ...]],
           stride: Union[int, Tuple[int, ...]] = 1,
           dilation: Union[int, Tuple[int, ...]] = 1,
           transposed: bool = False,
           out_capacity: Optional[int] = None,
           bias: Optional[torch.Tensor] = None,
           prefer_window: bool = False) -> SparseTensor:
    """Sparse conv with kernel-map caching in `x.kmaps`:

      * 1x1x1 stride-1: plain matmul, no coords change;
      * submanifold (stride 1): out coords == in coords;
      * strided: coords downsampled, new coord map registered in cmaps, and
        the inverse map built eagerly for the matching transposed conv;
      * transposed: reuses the plan of the matching down conv and restores
        the cached finer coord map.

    An f32 `bias` is added after the conv and promotes the result, as in
    the JAX package. `prefer_window` opts a submanifold conv over sorted
    rows into the window form (`uses_window`); its plan then gains the
    window arrays (`add_window_form`).
    """
    kernel_size = coordlib.make_ntuple(kernel_size)
    stride = coordlib.make_ntuple(stride)
    dilation = coordlib.make_ntuple(dilation)

    if kernel_size == (1, 1, 1) and stride == (1, 1, 1) and dilation == (1, 1, 1):
        # weight rounded to the feature dtype, products and sum in float32
        dt = x.feats.dtype
        feats = (x.feats.float() @ weight.to(dt).float()).to(dt)
        if bias is not None:
            feats = feats + bias
        return x.replace(feats=feats)

    if not transposed:
        key = ("plan", x.stride, kernel_size, stride, dilation)
        strided = any(s > 1 for s in stride)
        out_sorted = True if strided else x.coords_sorted
        offsets = coordlib.kernel_offsets_np(kernel_size, stride=x.stride,
                                             dilation=dilation)
        # the window form needs occupied x cells on the taps' x step
        # (dilation 1), rows in table order and a submanifold plan with a
        # mirror
        window_q = (x.stride[0] if prefer_window and not strided
                    and x.coords_sorted and dilation[0] == 1
                    and mirror_perm(offsets) is not None
                    and coordlib.can_group_offsets(offsets, x.stride[0])
                    else None)
        plan = x.kmaps.get(key)
        if plan is None or (window_q is not None and plan.groups is None):
            with span(PLAN):
                plan = _level_plan(x, plan, kernel_size, stride, offsets,
                                   window_q, out_capacity)
            x.kmaps[key] = plan

        feats = apply_conv_plan(x.feats, weight, plan,
                                prefer_window=prefer_window)
        if bias is not None:
            feats = feats + bias
        new_stride = tuple(x.stride[k] * stride[k] for k in range(3))
        out = SparseTensor(feats=feats, coords=plan.out_coords,
                           nnz=plan.out_nnz, stride=new_stride,
                           cmaps=x.cmaps, kmaps=x.kmaps,
                           base_sorted=x.base_sorted,
                           coords_sorted=out_sorted,
                           grid_extent=x.grid_extent)
    else:
        tensor_stride = tuple(x.stride[k] // stride[k] for k in range(3))
        tkey = ("plan", tensor_stride, kernel_size, stride, dilation)
        plan = x.kmaps[tkey]
        if plan.inv_idx is None:
            with span(PLAN):
                plan = plan.replace(inv_idx=invert_plan(plan))
            x.kmaps[tkey] = plan
        feats = apply_conv_plan(x.feats, weight, plan, transposed=True)
        if bias is not None:
            feats = feats + bias
        fine_coords, fine_nnz = x.cmaps[tensor_stride]
        # strided-conv products are sorted (unique_coords); the creation
        # stride map carries the creation flag
        fine_sorted = (tensor_stride != (1, 1, 1)) or x.base_sorted
        out = SparseTensor(feats=feats, coords=fine_coords, nnz=fine_nnz,
                           stride=tensor_stride, cmaps=x.cmaps,
                           kmaps=x.kmaps, base_sorted=x.base_sorted,
                           coords_sorted=fine_sorted,
                           grid_extent=x.grid_extent)

    out.cmaps.setdefault(out.stride, (out.coords, out.nnz))
    return out
