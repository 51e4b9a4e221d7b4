"""The backward of the window-form conv (`WindowConv`,
link_tpu_torch/sparse/conv.py) on the det backbone's submanifold plans.

A tiny frame (3,000 points over the 48 x 48 x 40 grid of
tests/test_det_train_step.py, collated at capacity 4,096) gives the
level-0 plan; its spconv down-sample (k3 s2 p1) gives the level-1 plan. On
each, the same numpy feats, weights and cotangent go through:

  * `WindowConv` (its kernels' plain twins on the CPU);
  * `jax.vjp` of `link_tpu.sparse.conv._gm_win_factory` over the same
    window arrays: d_feats and d_W at max|port - ref| / max|ref| < 1e-5,
    float32 on both sides with the same products summed in another order;
  * `GatherConv` over the same plan's kernel map and its mirrored inverse:
    the two forms' gradients equal at the same bound.

The widths are the det backbone's: 16 -> 16 and the stem's 5 -> 16 at level
0 (the stem's feats need no gradient, and no feature gradient is computed),
32 -> 32 at level 1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from link_tpu.sparse import conv as jconv
from link_tpu_torch.data import det_pipeline as tdp
from link_tpu_torch.ops import kernels
from link_tpu_torch.sparse import conv as tconv
from link_tpu_torch.sparse import coords as C
from link_tpu_torch.sparse.spconv_engine import (spconv_downsample,
                                                 spconv_out_shape)
from link_tpu_torch.sparse.tensor import make_sparse_tensor

from torch_threads import one_torch_thread  # noqa: F401

F32_TOL = 1e-5
CAP = 4096
GRID = (48, 48, 41)          # the backbone's level-0 shape: z extent + 1


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _window_plan(coords, nnz, cap):
    offs = C.kernel_offsets_np(3)
    table = C.build_table(coords, assume_sorted=True)
    return tconv.add_window_form(
        tconv.build_conv_plan(coords, coords, nnz, offs, cap, in_sorted=True,
                              table=table), table, offs, 1)


@pytest.fixture(scope="module")
def plans():
    rng = np.random.default_rng(70)
    pts = rng.uniform(-11, 11, (3000, 5)).astype(np.float32)
    pts[:, 2] = rng.uniform(-1.9, 1.9, 3000)
    v, c, n = tdp.points_to_voxel(pts, (0.5, 0.5, 0.1),
                                  (-12, -12, -2, 12, 12, 2), max_points=5,
                                  max_voxels=4000)
    batch = tdp.collate_det([{"voxels": v, "coords_zyx": c,
                              "num_points": n}], CAP, max_points=5)
    coords = torch.from_numpy(batch["coords"])
    nnz = torch.tensor(int(batch["nnz"]), dtype=torch.int32)
    shape1 = spconv_out_shape(GRID, (3, 3, 3), (2, 2, 2), (1, 1, 1))
    c1, nnz1 = spconv_downsample(coords, (3, 3, 3), (2, 2, 2), (1, 1, 1),
                                 shape1, CAP // 2)
    return {0: _window_plan(coords, nnz, CAP),
            1: _window_plan(c1, nnz1, CAP // 2)}


def _inputs(m, ci, co, seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((m, ci)).astype(np.float32)
    w = (rng.standard_normal((27, ci, co)) / np.sqrt(27 * ci)).astype(
        np.float32)
    cot = rng.standard_normal((m, co)).astype(np.float32)
    return feats, w, cot


def _port_grads(fn, feats, w, cot, feats_grad=True):
    f = torch.from_numpy(feats).requires_grad_(feats_grad)
    wt = torch.from_numpy(w).requires_grad_()
    out = fn(f, wt)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), (f.grad.numpy() if feats_grad else None), \
        wt.grad.numpy()


@pytest.mark.parametrize("level,ci,co", [(0, 16, 16), (1, 32, 32)])
def test_window_conv_gradients_match_jax_and_the_gather_form(plans, level, ci,
                                                             co):
    plan = plans[level]
    m = plan.slot.shape[1]
    assert plan.mirror is not None and plan.window == 3
    assert int(plan.out_nnz) > 1000 // (1 + 3 * level)
    feats, w, cot = _inputs(m, ci, co, level)
    out, d_feats, d_w = _port_grads(
        lambda f, wt: tconv.WindowConv.apply(f, wt, plan), feats, w, cot)

    fn = jconv._gm_win_factory(plan.groups, plan.self_group, plan.mirror)
    base_pos = jnp.asarray(plan.base_pos.numpy())
    slot = jnp.asarray(plan.slot.numpy())
    j_out, vjp = jax.vjp(lambda x, k: fn(x, k, base_pos, slot),
                         jnp.asarray(feats), jnp.asarray(w))
    j_feats, j_w = vjp(jnp.asarray(cot))
    assert _rel(out, j_out) < F32_TOL
    assert _rel(d_feats, j_feats) < F32_TOL
    assert _rel(d_w, j_w) < F32_TOL

    bwd = tconv.plan_bwd_idx(plan)
    g_out, g_feats, g_w = _port_grads(
        lambda f, wt: tconv.GatherConv.apply(f, wt, plan.in_idx, bwd,
                                             tconv.plan_wgrad_work(plan)),
        feats, w, cot)
    assert _rel(out, g_out) < F32_TOL
    assert _rel(d_feats, g_feats) < F32_TOL
    assert _rel(d_w, g_w) < F32_TOL


def test_stem_computes_no_feature_gradient(plans, monkeypatch):
    """The stem (5 -> 16) reads the voxel means, which need no gradient:
    its backward launches the weight gradient only, equal to JAX's."""
    plan = plans[0]
    m = plan.slot.shape[1]
    feats, w, cot = _inputs(m, 5, 16, 3)
    calls = []
    for name in ("window_conv", "gather_wgrad", "gather_conv"):
        real = getattr(kernels, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(kernels, name, spy)
    st = make_sparse_tensor(feats, plan.out_coords.numpy(),
                            nnz=int(plan.out_nnz), device="cpu",
                            base_sorted=True)
    st.kmaps[("plan", (1, 1, 1), (3, 3, 3), (1, 1, 1), (1, 1, 1))] = plan
    wt = torch.from_numpy(w).requires_grad_()
    out = tconv.conv3d(st, wt, 3, prefer_window=True).feats
    assert calls == ["window_conv"]
    out.backward(torch.from_numpy(cot))
    assert calls == ["window_conv", "gather_wgrad"]

    fn = jconv._gm_win_factory(plan.groups, plan.self_group, plan.mirror)
    _, vjp = jax.vjp(lambda k: fn(jnp.asarray(feats), k,
                                  jnp.asarray(plan.base_pos.numpy()),
                                  jnp.asarray(plan.slot.numpy())),
                     jnp.asarray(w))
    (j_w,) = vjp(jnp.asarray(cot))
    assert _rel(wt.grad.numpy(), j_w) < F32_TOL


def test_apply_conv_plan_trains_through_the_window_form(plans):
    """Under autograd the window plan keeps the window form (the choice
    inference makes) and its gradients are the gather form's."""
    plan = plans[0]
    m = plan.slot.shape[1]
    feats, w, cot = _inputs(m, 16, 16, 4)
    f = torch.from_numpy(feats)
    assert tconv.uses_window(plan, f, True)
    got = _port_grads(lambda x, k: tconv.apply_conv_plan(
        x, k, plan, prefer_window=True), feats, w, cot)
    want = _port_grads(lambda x, k: tconv.apply_conv_plan(x, k, plan),
                       feats, w, cot)
    for g, r in zip(got, want):
        assert _rel(g, r) < F32_TOL
