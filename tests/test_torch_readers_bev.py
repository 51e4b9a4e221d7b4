"""Port vs JAX: the pillar / dynamic readers (`models/readers.py`) and the
sparse -> BEV modules (`nn/bev.py`), on the cases of
tests/test_misc_modules.py:39-95.

The same seeded numpy clouds and points go through the JAX modules
(eager) and the port's, with the JAX init's weights copied over. Bounds:
coordinates, counts, masks and scatters exactly; float32 features 1e-6 of
the largest magnitude (the same sums in another order); the PillarFeatureNet
in train mode, its output and its BatchNorms' running statistics, 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from link_tpu.models import readers as JR
from link_tpu.nn import bev as JB
from link_tpu.sparse.tensor import make_sparse_tensor as j_make
from link_tpu_torch.models import readers as TR
from link_tpu_torch.nn import bev as TB
from link_tpu_torch.sparse.tensor import make_sparse_tensor as t_make

import oracles
from test_sparse_core import pad_coords, pad_feats
from torch_threads import one_torch_thread  # noqa: F401


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _cloud(seed, stride=1, batch=1, n=100, cap=128):
    rng = np.random.default_rng(seed)
    coords, feats = oracles.random_cloud(rng, n, span=(8, 8, 4), batch=batch,
                                         channels=6)
    coords[:, :3] *= stride
    c, f = pad_coords(coords, cap), pad_feats(feats, cap)
    j = j_make(jnp.asarray(f), jnp.asarray(c), nnz=len(coords),
               stride=stride)
    t = t_make(torch.from_numpy(np.array(f)), np.array(c), nnz=len(coords),
               stride=stride, device="cpu")
    return j, t, len(coords)


@pytest.mark.parametrize("stride,batch", [(1, 1), (2, 2)])
def test_to_bev_reduction_matches_jax(stride, batch):
    j, t, n = _cloud(1, stride, batch)
    want, got = JB.to_bev_reduction(j), TB.to_bev_reduction(t)
    assert int(got.nnz) == int(want.nnz) <= n
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    assert _rel(got.feats.numpy(), want.feats) < 1e-6
    assert (got.coords[:int(got.nnz), 2] == 0).all()


@pytest.mark.parametrize("stride,batch,bias", [(1, 1, False), (2, 2, True)])
def test_to_dense_bev_convolution_matches_jax(stride, batch, bias):
    j, t, _ = _cloud(2, stride, batch)
    shape = (8 * stride, 8 * stride, 4 * stride)
    jm = JB.ToDenseBEVConvolution(6, 8, shape=shape, use_bias=bias,
                                  batch_size=batch)
    v = jm.init(jax.random.PRNGKey(0), j)
    v = jax.tree_util.tree_map(np.asarray, v)
    if bias:
        v["params"]["bias"] = np.linspace(-1, 1, 8).astype(np.float32)
    tm = TB.ToDenseBEVConvolution(6, 8, shape, stride=stride, bias=bias,
                                  batch_size=batch, device="cpu")
    assert tm.kernel.shape == v["params"]["kernel"].shape
    with torch.no_grad():
        tm.kernel.copy_(torch.tensor(v["params"]["kernel"]))
        if bias:
            tm.bias.copy_(torch.tensor(v["params"]["bias"]))
    want = jm.apply(v, j)
    got = tm(t)
    assert got.shape == want.shape == (batch, 8, 8, 8)
    assert _rel(got.detach().numpy(), want) < 1e-6


@pytest.mark.parametrize("stride,batch", [(1, 1), (2, 2)])
def test_to_bev_height_compression_matches_jax(stride, batch):
    j, t, _ = _cloud(3, stride, batch)
    shape = (8 * stride, 8 * stride, 4 * stride)
    want = JB.to_bev_height_compression(j, shape, batch_size=batch)
    got = TB.to_bev_height_compression(t, shape, batch_size=batch)
    assert got.shape == want.shape == (batch, 6 * 4, 8, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _pillars(seed, n=64, p=10):
    rng = np.random.default_rng(seed)
    voxels = rng.standard_normal((n, p, 5)).astype(np.float32)
    npts = rng.integers(1, p + 1, n).astype(np.int32)
    coords = np.concatenate([rng.integers(0, 16, (n, 3)).astype(np.int32),
                             np.zeros((n, 1), np.int32)], 1)
    return voxels, npts, coords


def _port_pillar_net(v, filters, with_distance):
    net = TR.PillarFeatureNet(num_input_features=5, num_filters=filters,
                              with_distance=with_distance,
                              voxel_size=(0.5, 0.5), pc_range=(-4, -4),
                              device="cpu")
    sd = {}
    for i in range(len(filters)):
        p = v["params"][f"pfn{i}"]
        s = v["batch_stats"][f"pfn{i}"]["SparseBatchNorm_0"]
        bn = p["SparseBatchNorm_0"]
        sd[f"pfn_layers.{i}.linear.weight"] = np.asarray(
            p["Linear_0"]["kernel"]).T
        sd[f"pfn_layers.{i}.norm.weight"] = bn["scale"]
        sd[f"pfn_layers.{i}.norm.bias"] = bn["bias"]
        sd[f"pfn_layers.{i}.norm.running_mean"] = s["mean"]
        sd[f"pfn_layers.{i}.norm.running_var"] = s["var"]
        sd[f"pfn_layers.{i}.norm.num_batches_tracked"] = np.int64(0)
    net.load_state_dict({k: torch.tensor(np.array(a)) for k, a in sd.items()},
                        strict=True)
    return net


@pytest.mark.parametrize("filters,with_distance,train", [
    ((32,), False, False), ((16, 32), True, False), ((16, 32), False, True)])
def test_pillar_feature_net_matches_jax(filters, with_distance, train):
    voxels, npts, coords = _pillars(4)
    jm = JR.PillarFeatureNet(num_input_features=5, num_filters=filters,
                             with_distance=with_distance,
                             voxel_size=(0.5, 0.5), pc_range=(-4, -4))
    args = (jnp.asarray(voxels), jnp.asarray(npts), jnp.asarray(coords))
    v = jm.init(jax.random.PRNGKey(0), *args, False)
    net = _port_pillar_net(v, filters, with_distance)
    net.train(train)
    if train:
        want, upd = jm.apply(v, *args, True, mutable=["batch_stats"])
    else:
        want = jm.apply(v, *args, False)
    with torch.no_grad():
        got = net(torch.from_numpy(voxels), torch.from_numpy(npts),
                  torch.from_numpy(coords))
    assert got.shape == want.shape == (64, filters[-1])
    assert _rel(got.numpy(), want) < 1e-5
    if train:
        for i in range(len(filters)):
            s = upd["batch_stats"][f"pfn{i}"]["SparseBatchNorm_0"]
            norm = net.pfn_layers[i].norm
            assert _rel(norm.running_mean.numpy(), s["mean"]) < 1e-5
            assert _rel(norm.running_var.numpy(), s["var"]) < 1e-5


@pytest.mark.parametrize("nnz", [64, 40])
def test_point_pillars_scatter_matches_jax(nnz):
    _, _, coords = _pillars(5)
    coords[3, 0] = 99                            # outside the grid
    feats = np.random.default_rng(6).standard_normal((64, 32)).astype(
        np.float32)
    want = JR.point_pillars_scatter(jnp.asarray(feats), jnp.asarray(coords),
                                    jnp.int32(nnz), (16, 16), 1)
    got = TR.point_pillars_scatter(torch.from_numpy(feats),
                                   torch.from_numpy(coords), nnz, (16, 16), 1)
    assert got.shape == (1, 32, 16, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("capacity", [512, 64])
def test_dynamic_voxel_encoder_matches_jax(capacity):
    rng = np.random.default_rng(7)
    pts = rng.uniform(-4.5, 4.5, (500, 5)).astype(np.float32)
    valid = rng.uniform(size=500) < 0.9
    args = ((0.5, 0.5, 0.5), (-4, -4, -4, 4, 4, 4), (16, 16, 16))
    jf, jc, jn = JR.dynamic_voxel_encoder(jnp.asarray(pts),
                                          jnp.asarray(valid), *args,
                                          capacity=capacity)
    tf, tc, tn = TR.dynamic_voxel_encoder(torch.from_numpy(pts),
                                          torch.from_numpy(valid), *args,
                                          capacity=capacity)
    assert int(tn) == int(jn) > 0
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert _rel(tf.numpy(), jf) < 1e-6
