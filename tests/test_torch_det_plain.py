"""Port vs JAX: the plain CenterPoint VoxelNet (`elk=False`) and its
backbone, `SpMiddleResNetFHD`.

The tiny VoxelNet of tests/test_torch_det_model.py (grid (48, 48, 40),
capacities (4096, 2048, 1024, 512)) on its sample, in float32. Shared
weights: that file's reference-keyed state_dict, translated onto the JAX
trees by `translate_voxelnet`, with the ELK blocks and the tails taken out
of the trees (the plain model has none), and carried back to the port by
`from_jax_det_params`. One jitted JAX `VoxelNet(elk=False)` forward serves
the file; it also returns its backbone's BEV map (flax's
`capture_intermediates`). Bounds: 1e-5 of the largest magnitude, those of
tests/test_torch_det_model.py's goldens (float32 on both sides; the plain
model has no ELK block, whose aux sums the 2e-4 of the ELKv3 model's
comparison covers).
"""

import re

import numpy as np
import pytest
import torch

import jax

from link_tpu.models.scn import SpMiddleResNetFHD as JSpMiddleResNetFHD
from link_tpu.models.voxelnet import VoxelNet as JVoxelNet
from link_tpu.utils.torch_import_det import translate_voxelnet
from link_tpu_torch.data import det_pipeline as tdp
from link_tpu_torch.models.builder import build_detector
from link_tpu_torch.models.elk import ELKBlock
from link_tpu_torch.models.scn import SpMiddleResNetFHD
from link_tpu_torch.models.voxelnet import VoxelNet as TVoxelNet
from link_tpu_torch.train import det_trainer as TDT
from link_tpu_torch.train import schedules as TS
from link_tpu_torch.utils.convert import (from_jax_det_params,
                                          load_reference_state_dict)

from test_torch_det_model import CAPS, GRID, _reference_sd, _rel, _tiny_batch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
# the modules of the ELK branch, in the JAX trees and in the reference keys
ELK_TREE = re.compile(r"(elk\d|elk\d_tail|conv\d_tail)(_bn)?")
ELK_KEY = re.compile(r"backbone\.(elk\d|elk\d_tail|conv\d_tail)\.")


def _plain_tree(sd):
    """translate_voxelnet(sd) without the ELK blocks and tails."""
    tr = translate_voxelnet(sd)
    return {coll: {**tr[coll], "backbone": {
        k: v for k, v in tr[coll]["backbone"].items()
        if not ELK_TREE.fullmatch(k)}} for coll in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def shared():
    """(plain JAX variables, the port's state_dict from them)."""
    tree = _plain_tree(_reference_sd())
    return tree, from_jax_det_params(tree["params"], tree["batch_stats"])


def _port(sd, cls=TVoxelNet, **kw):
    model = cls(capacities=CAPS, device="cpu", **kw)
    load_reference_state_dict(model, sd)
    return model.eval()


def test_plain_models_carry_the_reference_keys_without_the_elk_branch(
        shared):
    _, sd = shared
    want = sorted(k for k in _reference_sd() if not ELK_KEY.match(k))
    assert sorted(sd) == want
    plain = TVoxelNet(capacities=CAPS, grid_shape=GRID, elk=False,
                      device="cpu")
    assert sorted(plain.state_dict()) == want
    assert not any(isinstance(m, ELKBlock) for m in plain.modules())
    backbone = SpMiddleResNetFHD(capacities=CAPS, device="cpu")
    assert backbone.elk is False and JSpMiddleResNetFHD.elk is False
    assert sorted("backbone." + k for k in backbone.state_dict()) == [
        k for k in want if k.startswith("backbone.")]
    # build_detector passes the config's `elk` to the model, as the JAX
    # builder's field filter does
    built = build_detector({"type": "VoxelNet", "elk": False,
                            "grid_shape": GRID, "capacities": CAPS,
                            "reader": {"type": "VoxelFeatureExtractorV3"}},
                           device="cpu")
    assert sorted(built.state_dict()) == want
    load_reference_state_dict(built, sd)


@pytest.fixture(scope="module")
def jax_outputs(shared):
    """The jitted JAX VoxelNet(elk=False): its head maps and its backbone's
    BEV map on the tiny sample."""
    tree, _ = shared
    batch = _tiny_batch()
    model = JVoxelNet(num_input_features=5, batch_size=1, grid_shape=GRID,
                      capacities=CAPS, elk=False)

    def fwd(v, *a):
        preds, inter = model.apply(
            v, *a, False, capture_intermediates=lambda mdl, _: (
                mdl.name == "backbone"))
        return preds, inter["intermediates"]["backbone"]["__call__"][0][0]

    preds, bev = jax.jit(fwd)(tree, batch["voxels"], batch["coords"],
                              batch["num_points"], batch["nnz"])
    return batch, preds, np.asarray(bev)


def test_plain_voxelnet_matches_jax(shared, jax_outputs):
    _, sd = shared
    batch, want, _ = jax_outputs
    assert int(batch["nnz"]) > 2000
    model = _port(sd, grid_shape=GRID, elk=False)
    with torch.inference_mode():
        got = model(*tdp.det_inputs(batch, "cpu"))
    assert len(got) == len(want) == 6
    for t, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].shape == w[k].shape
            assert _rel(g[k].numpy(), w[k]) < TOL, (t, k)


def test_sp_middle_resnet_fhd_matches_jax(shared, jax_outputs):
    _, sd = shared
    batch, _, want = jax_outputs
    backbone = SpMiddleResNetFHD(capacities=CAPS, device="cpu")
    backbone.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()
                              if k.startswith("backbone.")}, strict=True)
    backbone.eval()
    voxels, coords, npts, nnz = tdp.det_inputs(batch, "cpu")
    with torch.inference_mode():
        feats = voxels.sum(1) / npts.clamp(min=1).to(voxels.dtype)[:, None]
        got = backbone(feats, coords, nnz, GRID)
    assert got.shape == want.shape == (1, 128 * 2, 6, 6)
    assert _rel(got.numpy(), want) < TOL


def test_plain_voxelnet_trains(shared):
    """One one-cycle Adam step of the plain model on the tiny sample with
    a box: a finite loss and a nonzero gradient on every backbone weight
    (the heads of the five tasks without a box get none)."""
    _, sd = shared
    model = _port(sd, grid_shape=GRID, elk=False)
    rng = np.random.default_rng(50)
    pts = rng.uniform(-11, 11, (3000, 5)).astype(np.float32)
    pts[:, 2] = rng.uniform(-1.9, 1.9, 3000)
    v, c, n = tdp.points_to_voxel(pts, (0.5, 0.5, 0.1),
                                  (-12, -12, -2, 12, 12, 2), max_points=5,
                                  max_voxels=4000)
    t = tdp.assign_label(np.array([[0.0, 1.0, 0.0, 2.0, 4.0, 1.5, 0, 0, 0.1]],
                                  np.float32), np.array([1]),
                         pc_range=(-12, -12, -2, 12, 12, 2),
                         voxel_size=(0.5, 0.5, 0.1), out_size_factor=8,
                         max_objs=10)
    batch = tdp.collate_det([{"voxels": v, "coords_zyx": c, "num_points": n,
                              "targets": t}], CAPS[0], max_points=5)
    opt = TDT.make_one_cycle_adam(model, *TS.one_cycle(1e-3, 10))
    m = TDT.det_train_step(model, opt, batch)
    assert np.isfinite(float(m["loss"]))
    dead = [k for k, p in model.backbone.named_parameters()
            if p.grad is None or not bool((p.grad != 0).any())]
    # the biases of convs that feed a BatchNorm get a zero gradient
    assert all(k.endswith("bias") for k in dead), dead
