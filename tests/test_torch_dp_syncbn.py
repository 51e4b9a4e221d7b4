"""The port's SyncBN (a process group's replicas' statistics, JAX's
`axis_name` / `bn_axis`) on 2 gloo processes against the JAX package's
under `shard_map` over 2 CPU devices.

  * `SparseBatchNorm` synced against `link_tpu.nn.modules.SparseBatchNorm(
    axis_name=...)`, and `rpn.batch_norm_2d` of a synced BatchNorm2d
    against flax `nn.BatchNorm(axis_name=...)` (the RPN's eps 1e-3,
    momentum 0.01): each replica's output, the gradients of
    sum(output * ct) for its input and (per replica) for the scale and
    bias, and the running statistics after; float32, within 1e-5 of the
    largest magnitude;
  * a tiny MinkUNet (cr 0.125, capacities (384, 192, 96, 48, 24), seed-0
    weights carried by `translate_minkunet`) with every BatchNorm synced
    (`make_model`-style `sync_batch_norms`), one scan a replica, one SGD
    step on the ranks (`dp_check.run_ranks`, "sync_bn") against JAX's
    `seg_train_step(..., axis_name=DATA_AXIS)` of MinkUNet(bn_axis=
    DATA_AXIS) on each replica, as tests/test_train.py's `shard_step`
    runs it, but mapped by `jax.vmap(axis_name=DATA_AXIS)` in one jit:
    shard_map's compile of this graph takes far longer than this file's
    time on the CPU backend (tests/test_train.py's `shard_step` docstring
    warns of it). The loss terms 1e-4 absolute, each gradient leaf 1e-3 and each
    parameter 1e-3 of its leaf's largest magnitude, the running statistics
    1e-5.
"""

import functools

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from link_tpu.models.minkunet import MinkUNet as JMinkUNet
from link_tpu.nn.modules import SparseBatchNorm as JSparseBatchNorm
from link_tpu.sparse.tensor import make_sparse_tensor as j_make
from link_tpu.train import trainer as JT
from link_tpu.utils.torch_import import translate_minkunet
from link_tpu_torch.data.collate import collate_scans
from link_tpu_torch.data.semantic_kitti import SyntheticSemanticKITTI
from link_tpu_torch.models.minkunet import MinkUNet
from link_tpu_torch.nn.modules import SparseBatchNorm
from link_tpu_torch.tools import dp_check
from torch_dp_worker import bn_rank, spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_train_family import CAPS, CR, _capturing, flat

AX = JT.DATA_AXIS
N, C, B, H, W = 40, 6, 2, 5, 4
LR = 0.05


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.fixture(scope="module")
def bn_inputs():
    rng = np.random.default_rng(5)
    f32 = np.float32
    return {"feats": rng.normal(1.0, 2.0, (2, N, C)).astype(f32),
            "nnz": np.array([31, 17], np.int32),
            "ct": rng.normal(size=(2, N, C)).astype(f32),
            "scale": rng.uniform(0.5, 1.5, C).astype(f32),
            "bias": rng.normal(size=C).astype(f32),
            "x2d": rng.normal(0.5, 1.5, (2, B, C, H, W)).astype(f32),
            "ct2d": rng.normal(size=(2, B, C, H, W)).astype(f32),
            "scale2d": rng.uniform(0.5, 1.5, C).astype(f32),
            "bias2d": rng.normal(size=C).astype(f32)}


@pytest.fixture(scope="module")
def port_bn(bn_inputs, tmp_path_factory):
    return spawn(bn_rank, str(tmp_path_factory.mktemp("bn")), bn_inputs)


def _shard(fn, n_in):
    mesh = JT.make_data_mesh(jax.devices()[:2])
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P(AX),) * n_in,
                                 out_specs=P(AX), check_vma=False))


def test_sparse_batch_norm_sync_matches_jax(bn_inputs, port_bn):
    inp = bn_inputs
    coords = np.stack([np.arange(N), np.zeros(N), np.zeros(N),
                       np.zeros(N)], 1).astype(np.int32)
    bn = JSparseBatchNorm(C, axis_name=AX)
    params = {"scale": jnp.asarray(inp["scale"]),
              "bias": jnp.asarray(inp["bias"])}
    stats = {"mean": jnp.zeros(C), "var": jnp.ones(C)}

    def local(feats, nnz, ct):
        def f(x, p):
            st = j_make(x, coords, nnz=nnz[0])
            y, mut = bn.apply({"params": p, "batch_stats": stats}, st, True,
                              mutable=["batch_stats"])
            return y.feats, mut["batch_stats"]
        y, vjp, new = jax.vjp(f, feats[0], params, has_aux=True)
        dx, dp = vjp(ct[0])
        return (y[None], dx[None], dp["scale"][None], dp["bias"][None],
                new["mean"][None], new["var"][None])

    got = _shard(local, 3)(inp["feats"], inp["nnz"], inp["ct"])
    names = ("y", "dx", "dscale", "dbias", "mean", "var")
    for r in range(2):
        for name, want in zip(names, got):
            err = _rel(port_bn[r]["sparse"][name].numpy(), want[r])
            assert err < 1e-5, (r, name, err)
    # the statistics are both replicas' valid rows', not a replica's own
    rows = np.concatenate([inp["feats"][r][:inp["nnz"][r]] for r in (0, 1)])
    np.testing.assert_allclose(port_bn[0]["sparse"]["mean"].numpy(),
                               0.1 * rows.mean(0), rtol=1e-5, atol=1e-6)
    assert SparseBatchNorm(C).sync_group is None     # off by default


def test_batch_norm_2d_sync_matches_flax(bn_inputs, port_bn):
    inp = bn_inputs
    bn = fnn.BatchNorm(use_running_average=False, axis_name=AX,
                       epsilon=1e-3, momentum=0.99)
    params = {"scale": jnp.asarray(inp["scale2d"]),
              "bias": jnp.asarray(inp["bias2d"])}
    stats = {"mean": jnp.zeros(C), "var": jnp.ones(C)}

    def local(x, ct):
        x = jnp.transpose(x[0], (0, 2, 3, 1))           # NCHW -> NHWC
        ct = jnp.transpose(ct[0], (0, 2, 3, 1))

        def f(x, p):
            return bn.apply({"params": p, "batch_stats": stats}, x,
                            mutable=["batch_stats"])[0]
        y, vjp = jax.vjp(f, x, params)
        dx, dp = vjp(ct)
        new = bn.apply({"params": params, "batch_stats": stats}, x,
                       mutable=["batch_stats"])[1]["batch_stats"]
        back = lambda t: jnp.transpose(t, (0, 3, 1, 2))[None]
        return (back(y), back(dx), dp["scale"][None], dp["bias"][None],
                new["mean"][None], new["var"][None])

    got = _shard(local, 2)(inp["x2d"], inp["ct2d"])
    names = ("y", "dx", "dscale", "dbias", "mean", "var")
    for r in range(2):
        for name, want in zip(names, got):
            err = _rel(port_bn[r]["dense"][name].numpy(), want[r])
            assert err < 1e-5, (r, name, err)
        assert port_bn[r]["dense"]["tracked"] == 1


def _scans():
    ds = SyntheticSemanticKITTI(length=2, num_points=(CAPS[0] - 64) // 2,
                                n_raw_points=3000, voxel_size=0.4,
                                split="train", seed=11)
    return [collate_scans([ds[r]], CAPS[0]) for r in range(2)]


@pytest.fixture(scope="module")
def minkunet_steps(tmp_path_factory):
    scans = _scans()
    job = {"name": "mink", "step": "seg", "seed": 0, "sync_bn": True,
           "model": functools.partial(MinkUNet, 20, cr=CR,
                                      capacities=CAPS),
           "optimizer": functools.partial(dp_check.sgd, lr=LR),
           "step_kwargs": {"ignore_label": 0, "lr": LR},
           "batches": scans}
    workdir = str(tmp_path_factory.mktemp("mink"))
    dp_check.run_ranks([job], 2, "gloo", "cpu", workdir)
    snap = torch.load(f"{workdir}/mink_dp.pt")

    init = MinkUNet(20, cr=CR, capacities=CAPS, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    v = translate_minkunet({k: t.detach().numpy().copy()
                            for k, t in init.state_dict().items()})
    model = JMinkUNet(num_classes=20, cr=CR, capacities=CAPS, bn_axis=AX)
    tx = _capturing(JT.make_sgd(lambda step: LR, momentum=0.9,
                                weight_decay=1e-4, nesterov=True))
    state = JT.TrainState(step=jnp.int32(0), params=v["params"],
                          batch_stats=v["batch_stats"],
                          opt_state=tx.init(v["params"]))
    gb = JT.stack_device_batches(
        [{k: b[k] for k in ("feats", "coords", "labels", "nnz")}
         for b in scans])
    # every replica's seg_train_step(axis_name) mapped by vmap over the
    # named axis (shard_map's compile of this graph takes many minutes on
    # the CPU backend); each replica returns the same new state
    step = jax.jit(jax.vmap(lambda b: JT.seg_train_step(
        model, tx, state, b, axis_name=AX), axis_name=AX))
    new_state, jm = jax.tree_util.tree_map(lambda x: x[0], step(gb))
    grads = dict({k: t.numpy().copy() for k, t in snap["state"].items()},
                 **{k: g.numpy().copy() for k, g in snap["grads"].items()})
    return {"snap": snap, "port": translate_minkunet(
                {k: t.numpy().copy() for k, t in snap["state"].items()}),
            "port_grads": translate_minkunet(grads)["params"],
            "jax": new_state, "jm": jm}


def test_minkunet_sync_bn_loss_matches_jax(minkunet_steps):
    got, want = minkunet_steps["snap"]["metrics"], minkunet_steps["jm"]
    assert sorted(got) == sorted(want)
    for k in got:
        assert abs(got[k] - float(want[k])) < 1e-4, k


def test_minkunet_sync_bn_gradients_match_jax(minkunet_steps):
    got = flat(minkunet_steps["port_grads"], "params")
    want = flat(minkunet_steps["jax"].opt_state[1], "params")
    assert sorted(got) == sorted(want) and len(got) > 40
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-3 * np.abs(w).max(), k


def test_minkunet_sync_bn_state_matches_jax(minkunet_steps):
    port, jstate = minkunet_steps["port"], minkunet_steps["jax"]
    for coll, tol in (("params", 1e-3), ("batch_stats", 1e-5)):
        got, want = flat(port[coll], coll), flat(getattr(jstate, coll), coll)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert np.abs(got[k] - w).max() <= tol * np.abs(w).max(), k


def test_bn_group_reaches_every_batch_norm():
    """`bn_group` (JAX's `bn_axis`) of `make_model`, and `sync_batch_norms`
    on a `VoxelNet` and a `PillarFeatureNet`, sync every BatchNorm of the
    model, sparse and dense; without them none is synced."""
    import os
    from torch import nn
    from link_tpu_torch.models import builder
    from link_tpu_torch.models.readers import PillarFeatureNet
    from link_tpu_torch.models.voxelnet import VoxelNet
    from link_tpu_torch.nn.modules import sync_batch_norms
    from link_tpu_torch.utils.config import load_config

    group = object()        # stands for a process group: set, not used
    cfg = load_config(os.path.join(os.path.dirname(__file__), "..",
                                   "configs", "semantic_kitti", "minkunet",
                                   "default.yaml"), ["model.cr=0.125"])
    models = [builder.make_model(cfg, capacities=CAPS, device="cpu",
                                 bn_group=group),
              sync_batch_norms(VoxelNet(
                  batch_size=1, grid_shape=(48, 48, 40),
                  capacities=(8192, 4096, 2048, 1024), device="cpu"), group),
              sync_batch_norms(PillarFeatureNet(device="cpu"), group)]
    for m in models:
        norms = [x for x in m.modules() if isinstance(
            x, (SparseBatchNorm, nn.modules.batchnorm._BatchNorm))]
        assert norms and all(x.sync_group is group for x in norms)
    plain = builder.make_model(cfg, capacities=CAPS, device="cpu")
    assert all(getattr(x, "sync_group", None) is None
               for x in plain.modules())
