"""The port's data-parallel det train step on 2 gloo processes against the
JAX package's `make_det_train_step` on a 2-device mesh.

The tiny VoxelNet of tests/test_torch_det_train_step.py (grid (48, 48,
40), capacities (8192, 4096, 2048, 1024), batch 2) with two frames per
replica: replica 0 that file's two frames, replica 1 two more made by the
same recipe from the next seed; the shared weights of that file (the
port's seeded init through `translate_voxelnet` and back), one-cycle Adam
at `one_cycle(1e-3, 100)` with the clip at 35 on the averaged gradient.
Batch 2, as that file: at batch 1 the deep levels of these 3,000-point
frames hold so few rows that the one-device steps of the two packages
already differ beyond these bounds on some backbone gradients (ReLU
inputs at float noise on other sides), with or without data parallelism.
The port's ranks are spawned by `link_tpu_torch.tools.dp_check.run_ranks`
and run `det_train_step(..., group=WORLD)`; rank 0 hands back its loss
terms, gradients, parameters and running statistics. One jitted JAX step,
its optimizer wrapped to hand back the averaged gradients.

Bounds: those of tests/test_torch_det_train_step.py (the loss terms 2e-5
relative; each gradient leaf 1e-4 of its largest, a leaf of float noise
against the largest of all; the parameters by Adam's sign rule; every
running statistic 1e-5 of its largest).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from link_tpu.data import det_pipeline as jdp
from link_tpu.models.voxelnet import VoxelNet as JVoxelNet
from link_tpu.train import det_trainer as JDT
from link_tpu.train import schedules as JS
from link_tpu.train import trainer as JT
from link_tpu.utils.torch_import_det import translate_voxelnet
from link_tpu_torch.data import det_pipeline as tdp
from link_tpu_torch.models.voxelnet import VoxelNet as TVoxelNet
from link_tpu_torch.tools import dp_check
from link_tpu_torch.train import schedules as TS
from link_tpu_torch.utils.convert import from_jax_det_params
from test_torch_det_train_step import (CAPS, GRAD_TOL, GRID, LR, PC_RANGE,
                                       VOXEL, ZERO_LEAF, _frames, _leaf_rel,
                                       _stash_grads)
from torch_threads import one_torch_thread  # noqa: F401


def _replica_frames(pipeline, replica):
    """Replica 0: `_frames`; replica 1: two frames by its recipe from
    seed 71."""
    if replica == 0:
        return _frames(pipeline)
    rng = np.random.default_rng(71)
    out = []
    for i in range(2):
        pts = rng.uniform(-11, 11, (3000, 5)).astype(np.float32)
        pts[:, 2] = rng.uniform(-1.9, 1.9, 3000)
        v, c, n = pipeline.points_to_voxel(pts, VOXEL, PC_RANGE,
                                           max_points=5, max_voxels=4000)
        boxes = np.array([[1.0, -2.0 * i, 0.0, 2.0, 4.0, 1.5, 0, 0, 0.3]],
                         np.float32)
        t = pipeline.assign_label(boxes, np.array([1]), pc_range=PC_RANGE,
                                  voxel_size=VOXEL, out_size_factor=8,
                                  max_objs=10)
        out.append({"voxels": v, "coords_zyx": c, "num_points": n,
                    "targets": t})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("dpdet")
    init = TVoxelNet(batch_size=2, grid_shape=GRID, capacities=CAPS,
                     device="cpu", generator=torch.Generator().manual_seed(0))
    variables = translate_voxelnet({k: v.detach().numpy().copy()
                                    for k, v in init.state_dict().items()})
    shared = from_jax_det_params(variables["params"],
                                 variables["batch_stats"])
    torch.save(shared, workdir / "shared.pt")
    job = {"name": "det", "step": "det", "seed": 0,
           "model": functools.partial(TVoxelNet, batch_size=2,
                                      grid_shape=GRID, capacities=CAPS),
           "state": str(workdir / "shared.pt"),
           "optimizer": functools.partial(dp_check.one_cycle_adam,
                                          lr_max=LR[0], total_steps=LR[1]),
           "step_kwargs": {}, "lr": TS.one_cycle(*LR)[0](0),
           "batches": [tdp.collate_det(_replica_frames(tdp, r), CAPS[0],
                                       max_points=5) for r in range(2)]}
    ranks = dp_check.run_ranks([job], 2, "gloo", "cpu", str(workdir))

    gbatch = JT.stack_device_batches([
        {k: (list(v) if isinstance(v, list) else np.asarray(v))
         for k, v in jdp.collate_det(_replica_frames(jdp, r),
                                     voxel_capacity=CAPS[0], max_objs=10,
                                     max_points=5).items()
         if k in ("voxels", "coords", "num_points", "nnz")
         + tdp.TARGET_KEYS} for r in range(2)])
    model = JVoxelNet(num_input_features=5, batch_size=2, grid_shape=GRID,
                      capacities=CAPS)
    real = JDT.make_one_cycle_adam
    JDT.make_one_cycle_adam = _stash_grads(real)
    try:
        init_fn, jstep = JDT.make_det_train_step(
            model, *JS.one_cycle(*LR), mesh=JT.make_data_mesh(
                jax.devices()[:2]))
    finally:
        JDT.make_one_cycle_adam = real
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JT.TrainState(step=jnp.int32(0), params=params,
                          batch_stats=jax.tree_util.tree_map(
                              jnp.asarray, variables["batch_stats"]),
                          opt_state=init_fn(params))
    new_state, jmetrics = jstep(state, gbatch)
    port = TVoxelNet(batch_size=2, grid_shape=GRID, capacities=CAPS,
                     device="cpu")
    snap = torch.load(workdir / "det_dp.pt")
    port.load_state_dict(snap["state"])
    return dict(job=job, ranks=ranks, workdir=str(workdir), snap=snap,
                port=port, before=shared,
                jmetrics={k: float(v) for k, v in jmetrics.items()},
                jstate=new_state, jgrads=new_state.opt_state[1])


def test_dp_det_loss_terms_match_jax(runs):
    t, j = runs["snap"]["metrics"], runs["jmetrics"]
    assert sorted(t) == sorted(j) and len(t) == 13
    for k, v in j.items():
        assert abs(t[k] - v) <= 2e-5 * abs(v), (k, t[k], v)
    assert t["loss"] > 0


def test_dp_det_gradients_match_jax(runs):
    grads = runs["snap"]["grads"]
    sd = {k: grads.get(k, v).numpy().copy()
          for k, v in runs["snap"]["state"].items()}
    got = jax.tree_util.tree_leaves_with_path(translate_voxelnet(sd)
                                              ["params"])
    want = jax.tree_util.tree_leaves_with_path(runs["jgrads"])
    assert [p for p, _ in got] == [p for p, _ in want]
    top = max(float(np.abs(np.asarray(w)).max()) for _, w in want)
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        zero = np.abs(w).max() < ZERO_LEAF * top
        err = _leaf_rel(g, w, floor=top if zero else 0.0)
        assert err < GRAD_TOL, (jax.tree_util.keystr(path), err, zero)
    assert len(got) > 150


def test_dp_det_parameters_match_jax(runs):
    """Adam's sign rule of tests/test_torch_det_train_step.py."""
    lr = runs["job"]["lr"]
    jnew = from_jax_det_params(runs["jstate"].params,
                               runs["jstate"].batch_stats)
    grads = runs["snap"]["grads"]
    top = max(float(g.abs().max()) for g in grads.values())
    checked = 0
    for k, p in runs["port"].named_parameters():
        got, want = p.detach().numpy(), jnew[k].numpy()
        g = np.abs(grads[k].numpy())
        scale = g.max() if g.max() >= ZERO_LEAF * top else top
        sure = g > GRAD_TOL * scale
        if sure.any():
            d = np.abs(got - want)[sure]
            assert d.max() <= 1e-6 * np.abs(want).max() + 0.05 * lr, (
                k, d.max())
            checked += 1
        assert np.abs(got - want).max() <= 2 * lr, k
    assert checked > 150


def test_dp_det_running_stats_match_jax(runs):
    """Every running statistic, sparse and dense, the replicas' mean:
    within 1e-5 of its largest magnitude."""
    jnew = from_jax_det_params(runs["jstate"].params,
                               runs["jstate"].batch_stats)
    sd = runs["port"].state_dict()
    keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 80
    for k in keys:
        assert _leaf_rel(sd[k].numpy(), jnew[k].numpy()) < 1e-5, k
        assert not np.array_equal(sd[k].numpy(), runs["before"][k].numpy())
    assert all(int(v) == 1 for k, v in sd.items()
               if k.endswith("num_batches_tracked"))


def test_dp_det_ranks_equal_sequential_step_and_one_device_step(runs):
    """The 2-rank step equals `sequential_dp_step` and, both ranks given
    replica 0's frame, the one-device step; the ranks' parameters equal to
    the bit (else `hold` lists it under "failed")."""
    res = dp_check.hold(runs["job"], runs["ranks"], runs["workdir"],
                        torch.device("cpu"))
    for part in ("dp", "same"):
        assert res[part]["failed"] == [], res
        assert res[part]["loss_err"] <= 1e-5 and res[part]["grad"][0] <= \
            1e-5, res
