"""The port's det training step with the hybrid dense backbone
(`dense_from_level=2`) against one jitted JAX step, and against the port's
own fully sparse step.

The setup of tests/test_torch_det_train_step.py (its two frames, batch 2,
grid (48, 48, 40), capacities (8192, 4096, 2048, 1024), one_cycle(1e-3,
100), the JAX optimizer wrapped to hand back the gradients it was fed),
with the VoxelNets at `dense_from_level=2`: levels 2 and 3, their strided
downs and the extra conv run as masked dense convolutions. No level
overflows, so the dense step computes the sparse step's function.

Bounds, with what each measured:
  * against JAX's dense step, that file's bounds for the loss and each
    task's parts (2e-5 relative) and the batch statistics
    after the step (1e-5 of the buffer's largest magnitude);
  * the gradients against JAX's dense step: that file's 1e-4 of each
    leaf's largest magnitude, for the port's step as it is or with a ReLU
    cell whose input lies within KINK of zero put on its other side where
    the bias gradient of the BatchNorm before it shows that JAX's rounding
    put it there (measured 9.1e-5 with one cell flipped, 3.2e-2 without).
    The cell: the ReLU after the neck's deblock1 BatchNorm at channel 223,
    frame 0, BEV cell (0, 1), whose input is 5.0e-5 in the port's dense
    step, 1.0e-5 in a float64 run of it and 1.2e-5 in a float64 sparse
    one. JAX's jitted dense step puts it at or below zero: that BatchNorm
    channel's bias gradient differs from the port's by 6.212e-4, the
    gradient the port's ReLU passes there 6.211e-4. tests/dense_step_gap.py
    takes the readings (ROADMAP §3: a rounding gap at one kink, not a
    fault);
  * against the port's sparse step, that file's gradient bound: 1e-4 of
    each leaf's largest magnitude, a leaf whose largest gradient is below
    1e-7 of the largest of all (the biases that feed a BatchNorm) bounded
    against that largest.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from link_tpu.data import det_pipeline as jdp
from link_tpu.models.voxelnet import VoxelNet as JVoxelNet
from link_tpu.train import det_trainer as JDT
from link_tpu.train import schedules as JS
from link_tpu.train.trainer import TrainState as JTrainState
from link_tpu.utils.torch_import_det import translate_voxelnet
from link_tpu_torch.data import det_pipeline as tdp
from link_tpu_torch.models.voxelnet import VoxelNet as TVoxelNet
from link_tpu_torch.train import det_trainer as TDT
from link_tpu_torch.train import schedules as TS
from link_tpu_torch.utils.convert import from_jax_det_params, grads_state_dict

from test_torch_det_train_step import (CAPS, GRAD_TOL, GRID, LR, ZERO_LEAF,
                                       _frames, _leaf_rel, _stash_grads)
from torch_threads import one_torch_thread  # noqa: F401

LEVEL = 2
KINK = 1e-4        # a ReLU input this close to zero: either side may do


def _dense_step(shared, tbatch, flip=None):
    """The port's dense step from `shared`: (model, metrics, state dict
    before, the ReLU cells whose input lies within KINK of zero as
    (module, flat index, channel, what putting the cell on its other side
    adds to the gradient there: minus the gradient the ReLU passes, or
    the one it blocks)), the mask of cell `flip` on its other side."""
    port = TVoxelNet(batch_size=2, grid_shape=GRID, capacities=CAPS,
                     dense_from_level=LEVEL, device="cpu")
    port.load_state_dict(shared, strict=True)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    near, upstream, hooks = {}, {}, []

    def hook(mod, inp, out, name):
        x = inp[0]
        xf = x.detach().flatten()
        near[name] = (torch.nonzero(xf.abs() < KINK)[:, 0], xf > 0,
                      x.shape[1], x.shape[2] * x.shape[3])
        if flip is not None and flip[0] == name:
            mask = (x.detach() > 0).to(x.dtype).flatten()
            mask[flip[1]] = 1 - mask[flip[1]]
            out = x * mask.view_as(x)
        if out.requires_grad:
            out.register_hook(
                lambda g: upstream.__setitem__(name, g.flatten()))
        return out

    for name, mod in port.named_modules():
        if isinstance(mod, torch.nn.ReLU):
            hooks.append(mod.register_forward_hook(
                lambda mod, inp, out, name=name: hook(mod, inp, out, name)))
    opt = TDT.make_one_cycle_adam(port, *TS.one_cycle(*LR))
    tmetrics = TDT.det_train_step(port, opt, tbatch)
    for h in hooks:
        h.remove()
    kinks = [(name, int(i), int(i) // hw % c,
              float(upstream[name][i]) * (-1.0 if on[i] else 1.0))
             for name, (idx, on, c, hw) in near.items() for i in idx]
    return port, tmetrics, before, kinks


def _bn_bias_grad(sd, relu):
    """The gradient of the bias of the BatchNorm before ReLU module
    `relu`, from a state dict of gradients."""
    parent, i = relu.rsplit(".", 1)
    return sd[f"{parent}.{int(i) - 1}.bias"]


@pytest.fixture(scope="module")
def steps():
    init = TVoxelNet(batch_size=2, grid_shape=GRID, capacities=CAPS,
                     dense_from_level=LEVEL, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    variables = translate_voxelnet({k: v.detach().numpy().copy()
                                    for k, v in init.state_dict().items()})
    shared = from_jax_det_params(variables["params"],
                                 variables["batch_stats"])

    jbatch = jdp.collate_det(_frames(jdp), voxel_capacity=CAPS[0],
                             max_objs=10, max_points=5)
    gbatch = {k: np.asarray(jbatch[k])[None]
              for k in ("voxels", "coords", "num_points", "nnz")}
    for key in tdp.TARGET_KEYS:
        gbatch[key] = [np.asarray(v)[None] for v in jbatch[key]]
    model = JVoxelNet(num_input_features=5, batch_size=2, grid_shape=GRID,
                      capacities=CAPS, dense_from_level=LEVEL)
    lr_fn, mom_fn = JS.one_cycle(*LR)
    real = JDT.make_one_cycle_adam
    JDT.make_one_cycle_adam = _stash_grads(real)
    try:
        init_fn, jstep = JDT.make_det_train_step(model, lr_fn, mom_fn,
                                                 mesh=None)
    finally:
        JDT.make_one_cycle_adam = real
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JTrainState(step=jnp.int32(0), params=params,
                        batch_stats=jax.tree_util.tree_map(
                            jnp.asarray, variables["batch_stats"]),
                        opt_state=init_fn(params))
    new_state, jmetrics = jstep(state, gbatch)

    tbatch = tdp.collate_det(_frames(tdp), CAPS[0], max_points=5)
    port, tmetrics, before, kinks = _dense_step(shared, tbatch)
    sparse = TVoxelNet(batch_size=2, grid_shape=GRID, capacities=CAPS,
                       device="cpu")
    sparse.load_state_dict(shared, strict=True)
    smetrics = TDT.det_train_step(
        sparse, TDT.make_one_cycle_adam(sparse, *TS.one_cycle(*LR)), tbatch)
    return dict(jstate=new_state,
                jmetrics={k: float(v) for k, v in jmetrics.items()},
                jgrads=new_state.opt_state[1], port=port, before=before,
                shared=shared, tbatch=tbatch, kinks=kinks,
                tmetrics={k: float(v) for k, v in tmetrics.items()},
                sparse=sparse,
                smetrics={k: float(v) for k, v in smetrics.items()})


def test_dense_loss_and_its_parts_match_jax(steps):
    t, j = steps["tmetrics"], steps["jmetrics"]
    assert sorted(t) == sorted(j) and len(t) == 13
    for k, v in j.items():
        assert abs(t[k] - v) <= 2e-5 * abs(v), (k, t[k], v)
    assert t["loss"] > 0


def _grad_errs(got_tree, want_tree):
    """Each leaf's error against `want_tree`, of its largest magnitude (of
    the largest of all for a leaf below ZERO_LEAF of it)."""
    got = jax.tree_util.tree_leaves_with_path(got_tree)
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    top = max(float(np.abs(np.asarray(w)).max()) for _, w in want)
    errs = {}
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        zero = np.abs(w).max() < ZERO_LEAF * top
        errs[jax.tree_util.keystr(path)] = _leaf_rel(
            g, w, floor=top if zero else 0.0)
    return errs


def _tree(model):
    return translate_voxelnet(grads_state_dict(model))["params"]


@pytest.mark.parametrize("ref", ["jax", "sparse"])
def test_dense_gradient_leaves_match(steps, ref):
    if ref == "jax":
        # a BatchNorm channel's bias gradient sums what its ReLU passes:
        # a near-zero cell that JAX's rounding put on the other side shows
        # there as the change that flipping the port's cell makes
        port_sd = grads_state_dict(steps["port"])
        jax_sd = from_jax_det_params(steps["jgrads"],
                                     steps["jstate"].batch_stats)
        kinks = steps["kinks"]
        assert 0 < len(kinks) <= 64, len(kinks)
        flips = []
        for name, i, c, change in kinks:
            gap = float(_bn_bias_grad(jax_sd, name)[c]
                        - _bn_bias_grad(port_sd, name)[c])
            if abs(gap - change) < 0.5 * abs(gap):
                flips.append((name, i))
        assert len(flips) <= 4, flips
        trees = [_tree(steps["port"])] + [
            _tree(_dense_step(steps["shared"], steps["tbatch"], flip)[0])
            for flip in flips]
        errs = min((_grad_errs(t, steps["jgrads"]) for t in trees),
                   key=lambda e: max(e.values()))
    else:
        errs = _grad_errs(_tree(steps["port"]), _tree(steps["sparse"]))
    assert len(errs) > 150
    worst = max(errs, key=errs.get)
    assert errs[worst] < GRAD_TOL, (worst, errs[worst])
    # the dense levels' parameters got gradients
    grads = dict(steps["port"].named_parameters())
    for name in ("backbone.conv3.0.conv1.weight",
                 "backbone.elk4.pos_weight.0.weight",
                 "backbone.down3.0.weight", "backbone.extra_conv.0.weight"):
        assert grads[name].grad.abs().max() > 0, name


def test_dense_and_sparse_losses_match(steps):
    t, s = steps["tmetrics"], steps["smetrics"]
    for k, v in s.items():
        assert abs(t[k] - v) <= 2e-5 * abs(v), (k, t[k], v)


def test_dense_batch_statistics_after_one_step_match_jax(steps):
    jnew = from_jax_det_params(steps["jstate"].params,
                               steps["jstate"].batch_stats)
    sd = steps["port"].state_dict()
    keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 80
    for k in keys:
        got, want = sd[k].numpy(), jnew[k].numpy()
        assert _leaf_rel(got, want) < 1e-5, k
        assert not np.array_equal(got, steps["before"][k].numpy()), k
