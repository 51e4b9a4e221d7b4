"""Port vs JAX: the registry (`link_tpu_torch/utils/registry.py`) and the
registry-driven builders of `link_tpu_torch/models/builder.py`.

`Registry`, `build_from_cfg` (default arguments fill only missing keys; an
unknown type raises the same KeyError) and `get_downsample_factor` on the
same inputs as the JAX package; `register_det_builtins` fills each registry
with the same names; `make_model` falls back to a registered seg model;
`build_detector` from a reference-style dict, nested reader / backbone /
neck / head dicts included, builds a tiny VoxelNet (grid (48, 48, 40),
the tests' capacities) whose forward equals JAX's `build_detector` model
with the same weights, carried by `utils/convert` (every head map at rel
< 2e-4, the bound of tests/test_torch_det_model.py).
"""

import numpy as np
import pytest
import torch

import jax

from link_tpu.models import builder as JB
from link_tpu.utils import registry as JR
from link_tpu.utils.torch_import_det import translate_voxelnet
from link_tpu_torch.data import det_pipeline as tdp
from link_tpu_torch.models import builder as TB
from link_tpu_torch.utils import registry as TR
from link_tpu_torch.utils.config import Config
from link_tpu_torch.utils.convert import from_jax_det_params
from test_torch_det_model import _rel, _tiny_batch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GRID = (48, 48, 40)
CAPS = (4096, 2048, 1024, 512)


@pytest.mark.parametrize("cfg", [
    {"neck": {"ds_layer_strides": [1, 2], "us_layer_strides": [1, 2]},
     "backbone": {"ds_factor": 8}},
    {"neck": {"ds_layer_strides": [2, 2], "us_layer_strides": [1, 4]}},
    {"neck": {"ds_layer_strides": [1], "us_layer_strides": []},
     "backbone": {"ds_factor": 4}},
    {"neck": {}},
    {"backbone": {"ds_factor": 4}},
    {"neck": None}])
def test_get_downsample_factor_matches_jax(cfg):
    assert TR.get_downsample_factor(cfg) == JR.get_downsample_factor(cfg)


def test_registry_and_build_from_cfg_match_jax():
    out = []
    for R in (TR, JR):
        reg = R.Registry("test")

        @reg.register_module
        class Foo:
            def __init__(self, width, depth=1):
                self.width, self.depth = width, depth

        reg.register_module(Foo, name="Bar")
        a = R.build_from_cfg({"type": "Foo", "width": 5}, reg,
                             default_args={"width": 9, "depth": 3})
        b = R.build_from_cfg({"type": "Bar", "width": 2}, reg)
        with pytest.raises(KeyError) as e:
            R.build_from_cfg({"type": "Baz"}, reg)
        out.append(((a.width, a.depth), (b.width, b.depth), str(e.value),
                    "Foo" in reg, "Baz" in reg, reg.get("Baz")))
    assert out[0] == out[1] == (
        (5, 3), (2, 1), "'Baz not in test registry'", True, False, None)


def test_register_det_builtins_fills_the_jax_names():
    TB.register_det_builtins()
    JB.register_det_builtins()
    for name in ("READERS", "BACKBONES", "NECKS", "HEADS", "DETECTORS",
                 "DATASETS", "PIPELINES"):
        t, j = getattr(TR, name), getattr(JR, name)
        assert t.name == j.name
        assert sorted(t._modules) == sorted(j._modules), name
    assert sorted(TB.SEG_MODELS._modules) == sorted(JB.SEG_MODELS._modules)
    assert TR.DATASETS.get("WaymoDataset").__module__ == \
        "link_tpu_torch.data.waymo"


def test_make_model_builds_a_registered_seg_model():
    @TB.SEG_MODELS.register_module(name="tiny_seg")
    class TinySeg(torch.nn.Module):
        def __init__(self, num_classes, capacities, device, width=4):
            super().__init__()
            self.capacities = capacities
            self.head = torch.nn.Linear(width, num_classes, device=device)

    try:
        cfg = Config({"model": {"name": "tiny_seg", "width": 3},
                      "data": {"num_classes": 7}})
        m = TB.make_model(cfg, capacities=(64, 32), device="cpu")
        assert isinstance(m, TinySeg) and m.capacities == (64, 32)
        assert tuple(m.head.weight.shape) == (7, 3)
    finally:
        TB.SEG_MODELS._modules.pop("tiny_seg")


REFERENCE_CFG = dict(
    type="VoxelNet", num_input_features=5, grid_shape=GRID, capacities=CAPS,
    reader=dict(type="VoxelFeatureExtractorV3", num_input_features=5),
    backbone=dict(type="SpMiddleResNetFHDELKv3", num_input_features=5,
                  ds_factor=8),
    neck=dict(type="RPN", layer_nums=[5, 5], ds_layer_strides=[1, 2],
              ds_num_filters=[128, 256], us_layer_strides=[1, 2],
              us_num_filters=[256, 256], num_input_features=256),
    bbox_head=dict(type="CenterHead", in_channels=512),
    pretrained=None)


def test_build_detector_matches_jax_build_detector():
    """Unknown keys dropped, default_args fill only what the dict lacks
    (the dict's capacities stay; batch_size comes from them); the forward
    of the tiny model with JAX's weights carried by utils/convert."""
    got = TB.build_detector(REFERENCE_CFG, device="cpu", batch_size=1,
                            capacities=(8, 8, 8, 8))
    want = JB.build_detector(REFERENCE_CFG, batch_size=1,
                             capacities=(8, 8, 8, 8))
    assert got.backbone.capacities == want.capacities == CAPS
    assert got.grid_shape == want.grid_shape == GRID
    with pytest.raises(KeyError, match="Nope not in detector registry"):
        TB.build_detector({"type": "Nope"})

    # weights: a seeded port model through the reference layout into JAX,
    # and back into the port through utils/convert
    seeded = TB.build_detector(REFERENCE_CFG, device="cpu",
                               generator=torch.Generator().manual_seed(3))
    sd = {k: v.detach().clone().numpy()
          for k, v in seeded.state_dict().items()}
    tr = translate_voxelnet(sd)
    back = from_jax_det_params(tr["params"], tr["batch_stats"])
    got.load_state_dict(back, strict=True)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], k)
    got.eval()
    batch = _tiny_batch()
    with torch.inference_mode():
        g = got(*tdp.det_inputs(batch, "cpu"))
    w = jax.jit(lambda v, *a: want.apply(v, *a, False))(
        tr, batch["voxels"], batch["coords"], batch["num_points"],
        batch["nnz"])
    assert len(g) == len(w) == 6
    for t, (gt, wt) in enumerate(zip(g, w)):
        for k in wt:
            assert _rel(gt[k].numpy(), wt[k]) < 2e-4, (t, k)
