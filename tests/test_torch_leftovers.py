"""The port's `GlobalAveragePool`, `GlobalMaxPool`, `crop`, `relu`,
`make_criterion` and `make_dataset` against the JAX package's
(`link_tpu/nn/modules.py`, `link_tpu/models/builder.py`), on the inputs of
tests/test_misc_modules.py: random voxel clouds (`oracles.random_cloud`)
padded to a capacity with garbage feature rows. Pools, crop and relu
exactly (the same sums in one order on the CPU; the means within 1 ulp);
the criteria within 1e-6 relative; the datasets' scans equal."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from link_tpu.models import builder as jbuilder
from link_tpu.nn import modules as jnn
from link_tpu.sparse.tensor import make_sparse_tensor as j_make
from link_tpu.utils.config import load_config as j_load_config
from link_tpu_torch.models import builder as tbuilder
from link_tpu_torch.nn import modules as tnn
from link_tpu_torch.sparse.tensor import make_sparse_tensor as t_make
from link_tpu_torch.utils.config import load_config as t_load_config

import oracles
from test_sparse_core import pad_coords, pad_feats
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "semantic_kitti", "minkunet",
    "default.yaml")


def _cloud(seed, n, cap, span=(10, 10, 4), batch=1):
    rng = np.random.default_rng(seed)
    coords, feats = oracles.random_cloud(rng, n, span=span, batch=batch)
    return (pad_feats(feats, cap), pad_coords(coords, cap), len(coords),
            coords)


def _both(feats, coords, nnz):
    return (j_make(feats, coords, nnz=nnz),
            t_make(feats, coords, nnz=nnz, device="cpu"))


@pytest.mark.parametrize("pool", ["GlobalAveragePool", "GlobalMaxPool"])
@pytest.mark.parametrize("batch", [1, 3])
def test_global_pools_match_jax(pool, batch):
    feats, coords, nnz, _ = _cloud(2 + batch, 80, 96, batch=batch)
    js, ts = _both(feats, coords, nnz)
    want = np.asarray(getattr(jnn, pool)(max_batch=4).apply({}, js))
    got = getattr(tnn, pool)(max_batch=4)(ts).numpy()
    assert got.shape == want.shape == (4, feats.shape[1])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # batch elements without voxels pool to zeros in both
    assert not got[batch:].any()


def test_crop_and_relu_match_jax():
    feats, coords, nnz, raw = _cloud(2, 80, 96)
    js, ts = _both(feats, coords, nnz)
    jc = jnn.crop(js, (0, 0, 0), (5, 5, 4))
    tc = tnn.crop(ts, (0, 0, 0), (5, 5, 4))
    inside = ((raw[:, :3] >= 0) & (raw[:, :3] < [5, 5, 4])).all(1)
    assert int(tc.nnz) == int(jc.nnz) == inside.sum() > 0
    np.testing.assert_array_equal(tc.coords.numpy(), np.asarray(jc.coords))
    np.testing.assert_array_equal(tc.valid_mask().numpy(),
                                  np.asarray(jc.valid_mask()))
    jr, tr = jnn.relu(js), tnn.relu(ts)
    np.testing.assert_array_equal(tr.feats.numpy(), np.asarray(jr.feats))
    assert torch.equal(tnn.SparseReLU()(ts).feats, tr.feats)


@pytest.mark.parametrize("name", ["lovasz_softmax", "cross_entropy"])
def test_make_criterion_matches_jax(name):
    over = [f"criterion.name={name}"]
    jcrit = jbuilder.make_criterion(j_load_config(CONFIG, over))
    tcrit = tbuilder.make_criterion(t_load_config(CONFIG, over))
    rng = np.random.default_rng(9)
    n, c = 120, 20
    logits = rng.standard_normal((n, c)).astype(np.float32) * 2
    labels = rng.integers(0, c, n).astype(np.int32)
    valid = np.arange(n) < 100
    jl, jlogs = jcrit(jnp.asarray(logits), jnp.asarray(labels),
                      jnp.asarray(valid))
    tl, tlogs = tcrit(torch.from_numpy(logits),
                      torch.from_numpy(labels).long(),
                      torch.from_numpy(valid))
    assert sorted(tlogs) == sorted(jlogs)
    for k in jlogs:
        assert abs(float(tlogs[k]) - float(jlogs[k])) <= 1e-6 * abs(
            float(jlogs[k])), k
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    with pytest.raises(NotImplementedError):
        tbuilder.make_criterion(t_load_config(CONFIG,
                                              ["criterion.name=focal"]))


def test_make_dataset_matches_jax(tmp_path):
    """"synthetic" scans equal to the JAX builder's; "semantic_kitti" the
    reader over a tree the port writes, equal to JAX's reader over it."""
    from link_tpu_torch.data.semantic_kitti import write_synthetic_tree
    over = ["dataset.name=synthetic", "dataset.length=2",
            "dataset.num_points=500", "dataset.voxel_size=0.4"]
    for name, extra in (("synthetic", []),
                        ("semantic_kitti", [f"dataset.root={tmp_path}"])):
        if name == "semantic_kitti":
            write_synthetic_tree(str(tmp_path), {"08": 2})
            over = [o for o in over if not o.startswith("dataset.name")]
        # the val split: the reader's train split augments with an
        # unseeded draw when no generator is given
        j = jbuilder.make_dataset(j_load_config(CONFIG, over + extra), "val")
        t = tbuilder.make_dataset(t_load_config(CONFIG, over + extra), "val")
        assert len(t) == len(j) == 2, name
        for a, b in zip((t[0], t[1]), (j[0], j[1])):
            assert sorted(a) == sorted(b), name
            for k in b:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]), (name, k))
    with pytest.raises(NotImplementedError):
        tbuilder.make_dataset(t_load_config(CONFIG, ["dataset.name=x"]))
