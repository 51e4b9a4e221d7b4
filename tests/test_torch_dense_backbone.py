"""Port vs JAX: the hybrid dense det backbone (`dense_from_level`).

The inputs of tests/test_dense_backbone.py: 500 distinct voxels of batch 2
on the (48, 48, 40) grid, capacities 2,048 at every level, so that no level
overflows and the dense path (which cannot overflow) keeps the same rows as
the sparse one. Weights: the port's seeded tiny VoxelNet, carried to the
JAX trees by `translate_voxelnet`. The JAX backbone runs eagerly (no jit).

Bounds (float32 on both sides), rtol and atol 2e-4 as the JAX package's
own tests/test_dense_backbone.py (measured ~1.5e-6 relative):
  * the BEV of `dense_from_level` 1 and 2 against JAX's at the same level,
    and against the port's fully sparse backbone; levels 0 and 3 against
    the port's sparse backbone;
  * in train mode at level 2: the BEV, and every BatchNorm's running
    statistics after the step, against JAX's dense step and the port's
    sparse one;
  * `det_test --dense-from-level 2` at the tests' tiny grid (the tool's
    patched `GRID`, `CAPACITY`, `TEST_CFG`, dataset): its model's maps
    against the jitted JAX VoxelNet(dense_from_level=2), rel 2e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from link_tpu.models.scn import SpMiddleResNetFHDELKv3 as JBackbone
from link_tpu.utils.torch_import_det import translate_voxelnet
from link_tpu_torch.models.scn import det_capacities
from link_tpu_torch.models.voxelnet import VoxelNet as TVoxelNet
from link_tpu_torch.sparse import coords as tcoords
from link_tpu_torch.sparse.dense_grid import DenseGrid
from link_tpu_torch.utils.convert import from_jax_det_params

from test_torch_det_test_tool import tiny, tree  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

GRID = (48, 48, 40)
BATCH = 2
CAPS = (2048, 2048, 2048, 2048)
TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs():
    """tests/test_dense_backbone.py's inputs (its `_inputs(rng(0))`)."""
    rng = np.random.default_rng(0)
    n = 500
    pts = np.unique(np.stack(
        [rng.integers(0, GRID[0], 4 * n), rng.integers(0, GRID[1], 4 * n),
         rng.integers(0, GRID[2], 4 * n), rng.integers(0, BATCH, 4 * n)],
        1).astype(np.int32), axis=0)[:n]
    key = ((pts[:, 3].astype(np.int64) * (GRID[2] + 1) + pts[:, 2])
           * GRID[1] + pts[:, 1]) * GRID[0] + pts[:, 0]
    pts = pts[np.argsort(key)]
    feats = np.zeros((CAPS[0], 5), np.float32)
    feats[:len(pts)] = rng.standard_normal((len(pts), 5))
    coords = np.full((CAPS[0], 4), tcoords.INVALID_COORD, np.int32)
    coords[:len(pts)] = pts
    return feats, coords, len(pts)


@pytest.fixture(scope="module")
def setup():
    init = TVoxelNet(batch_size=BATCH, grid_shape=GRID, capacities=CAPS,
                     device="cpu", generator=torch.Generator().manual_seed(0))
    sd = {k: v.detach().clone() for k, v in init.state_dict().items()}
    tr = translate_voxelnet({k: v.numpy().copy() for k, v in sd.items()})
    variables = {"params": tr["params"]["backbone"],
                 "batch_stats": tr["batch_stats"]["backbone"]}
    return sd, tr, variables, _inputs()


def _port(sd, level, train=False):
    model = TVoxelNet(batch_size=BATCH, grid_shape=GRID, capacities=CAPS,
                      dense_from_level=level, device="cpu")
    model.load_state_dict(sd, strict=True)
    return model.train(train).backbone


def _port_bev(sd, inputs, level, train=False):
    backbone = _port(sd, level, train)
    feats, coords, n = inputs
    with torch.no_grad():
        bev = backbone(torch.from_numpy(feats), torch.from_numpy(coords),
                       torch.tensor(n), GRID)
    return bev.numpy(), backbone


def _jax(variables, inputs, level, train=False):
    feats, coords, n = inputs
    model = JBackbone(num_input_features=5, capacities=CAPS,
                      batch_size=BATCH, dense_from_level=level)
    args = (jnp.asarray(feats), jnp.asarray(coords), jnp.int32(n), GRID)
    if train:
        (bev, _), upd = model.apply(variables, *args, True,
                                    mutable=["batch_stats"])
        return np.asarray(bev), upd["batch_stats"]
    bev, _ = model.apply(variables, *args, False)
    return np.asarray(bev), None


@pytest.mark.parametrize("level", [1, 2])
def test_dense_backbone_matches_jax_and_the_sparse_port(setup, level):
    sd, _, variables, inputs = setup
    got, _ = _port_bev(sd, inputs, level)
    want, _ = _jax(variables, inputs, level)
    assert got.shape == want.shape == (BATCH, 256, 6, 6)
    np.testing.assert_allclose(got, want, **TOL)
    sparse, _ = _port_bev(sd, inputs, None)
    np.testing.assert_allclose(got, sparse, **TOL)


@pytest.mark.parametrize("level", [0, 3])
def test_dense_backbone_matches_the_sparse_port(setup, level):
    sd, _, _, inputs = setup
    got, _ = _port_bev(sd, inputs, level)
    sparse, _ = _port_bev(sd, inputs, None)
    np.testing.assert_allclose(got, sparse, **TOL)


def test_the_levels_from_l_on_run_dense(setup, monkeypatch):
    """At dense_from_level=2 the blocks of the 0-based levels 2 and 3
    (conv3, conv4) see a DenseGrid, those of levels 0 and 1 a
    SparseTensor."""
    sd, _, _, inputs = setup
    backbone = _port(sd, 2)
    seen = {}
    for lvl in (1, 2, 3, 4):
        mod = getattr(backbone, f"conv{lvl}")
        real = mod.forward

        def spy(x, _lvl=lvl, _real=real):
            seen[_lvl] = isinstance(x, DenseGrid)
            return _real(x)
        monkeypatch.setattr(mod, "forward", spy)
    feats, coords, n = inputs
    with torch.no_grad():
        backbone(torch.from_numpy(feats), torch.from_numpy(coords),
                 torch.tensor(n), GRID)
    assert seen == {1: False, 2: False, 3: True, 4: True}


def test_dense_train_statistics_match_jax_and_the_sparse_port(setup):
    """Train mode at level 2: the BEV and every BatchNorm's running
    statistics after one forward."""
    sd, tr, variables, inputs = setup
    got, dense = _port_bev(sd, inputs, 2, train=True)
    want, stats = _jax(variables, inputs, 2, train=True)
    np.testing.assert_allclose(got, want, **TOL)
    sparse_bev, sparse = _port_bev(sd, inputs, None, train=True)
    np.testing.assert_allclose(got, sparse_bev, **TOL)
    ref = from_jax_det_params(
        tr["params"], {**tr["batch_stats"], "backbone": stats})
    mine, other = dense.state_dict(), sparse.state_dict()
    keys = [k for k in mine if k.endswith(("running_mean", "running_var"))]
    # the stem, 4 x (4 block + 2 tail), 3 downs and the extra conv
    assert len(keys) == 2 * 29
    for k in keys:
        np.testing.assert_allclose(mine[k].numpy(),
                                   ref[f"backbone.{k}"].numpy(), **TOL,
                                   err_msg=k)
        np.testing.assert_allclose(mine[k].numpy(), other[k].numpy(), **TOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_dense_voxelnet():
    from link_tpu.models.voxelnet import VoxelNet as JVoxelNet
    from test_torch_det_test_tool import GRID as TOOL_GRID
    model = JVoxelNet(num_input_features=5, batch_size=1,
                      grid_shape=TOOL_GRID,
                      capacities=det_capacities(4096, 1), dense_from_level=2)
    return jax.jit(lambda v, *a: model.apply(v, *a, False))


def test_det_test_dense_from_level_matches_jax(tree, tiny, jax_dense_voxelnet):
    """det_test --dense-from-level 2 at the tests' tiny grid: its model's
    head maps against the jitted JAX VoxelNet(dense_from_level=2) on each
    frame's batch with the same weights (rel 2e-4, the tiny VoxelNet's
    bound in tests/test_torch_det_model.py), and its records those of the
    model's own decode and NMS."""
    from link_tpu_torch.data import det_pipeline as tdp
    from link_tpu_torch.inference import masked_rows
    from link_tpu_torch.tools import det_test
    flags = ["--info-path", tree[1]["val"], "--root-path", tree[0],
             "--device", "cpu", "--dense-from-level", "2"]
    r = det_test.evaluate(det_test.parse_args(flags))
    assert len(r["samples"]) == 2
    run = det_test.DetTest(det_test.parse_args(flags), "cpu")
    assert run.model.backbone.dense_from_level == 2
    variables = translate_voxelnet({k: v.numpy().copy() for k, v in
                                    run.model.state_dict().items()})
    ds = det_test.make_dataset(det_test.parse_args(flags))
    kept = 0
    for i, rec in enumerate(r["samples"]):
        batch = run.batch(ds[i])
        with torch.no_grad():
            preds = run.model(*tdp.det_inputs(batch, "cpu"))
        want = jax_dense_voxelnet(variables, batch["voxels"],
                                  batch["coords"], batch["num_points"],
                                  batch["nnz"])
        for g, w in zip(preds, want):
            for k in w:
                got = g[k].numpy()
                assert (np.abs(got - np.asarray(w[k])).max()
                        < 2e-4 * np.abs(np.asarray(w[k])).max()), k
        for got, key in zip(run.detections(masked_rows(run.forward(batch))),
                            ("pred_boxes", "pred_scores", "pred_labels")):
            np.testing.assert_array_equal(rec[key], got)
        kept += len(rec["pred_scores"])
    assert kept > 0
