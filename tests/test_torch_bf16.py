"""The port in bfloat16 against the JAX package in bfloat16, on shared
weights: the seg families the port serves in bfloat16 (ELKUNet, MinkUNet,
ELKEncoder; SPVCNN is float32 only in both) on their cr0.25 goldens'
clouds and reference weights, and the tiny det VoxelNet of
tests/test_torch_det_model.py.

Both packages run the same graph with the same casts (bfloat16 convs and
matmuls, float32 where the model promotes: pooling sums, the ELK trig
factors, the det SubM biases), so they differ by the summation order inside
each bfloat16 product, one rounding of a bfloat16 result at most:
  * seg logits: max|port - jax| / max|jax| < 2e-5 (on this CPU: ELKUNet
    7.6e-6, ELKEncoder 5.3e-7, MinkUNet 0), and the argmax equal on every
    voxel whose top-2 margin exceeds that bound times max|jax|;
  * det BEV (the backbone's output, float32 after level 0): < 1e-5 (1.0e-6);
  * det head maps: < 4e-2 (2.6e-2). The dense RPN and head run bfloat16
    convs, where one torch `conv2d` and one XLA conv round 0.01% of their
    outputs apart by up to 2 ulps, and each later layer carries that on;
    each package's own bfloat16-vs-float32 distance on these maps is
    2-3e-2.
One jitted JAX forward per model.
"""

import os

import jax
import numpy as np
import pytest
import torch

from link_tpu.models.linkencoder import ELKEncoder as JELKEncoder
from link_tpu.models.linkunet import ELKUNet as JELKUNet
from link_tpu.models.minkunet import MinkUNet as JMinkUNet
from link_tpu.models.voxelnet import VoxelNet as JVoxelNet
from link_tpu.sparse.tensor import make_sparse_tensor as j_make
from link_tpu.utils.torch_import import (translate_elkencoder,
                                         translate_elkunet,
                                         translate_minkunet)
from link_tpu.utils.torch_import_det import translate_voxelnet
from link_tpu_torch.data import det_pipeline as tdp
from link_tpu_torch.models.linkencoder import ELKEncoder
from link_tpu_torch.models.linkunet import ELKUNet
from link_tpu_torch.models.minkunet import MinkUNet
from link_tpu_torch.models.voxelnet import VoxelNet
from link_tpu_torch.sparse.tensor import make_sparse_tensor as t_make
from link_tpu_torch.utils.convert import load_reference_state_dict
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from test_torch_det_model import CAPS as DET_CAPS, GRID, _reference_sd, \
    _tiny_batch, _torch_sd

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
CAPS = (1024, 640, 256, 128, 64)
ENC_ARCH = dict(r=3, s=5, groups=2, baseop="cos")
SEG_TOL = 2e-5
BEV_TOL = 1e-5
HEAD_TOL = 4e-2

# family -> (golden, port class and kwargs, JAX class and kwargs, translate)
SEG = {
    "elkunet": ("elkunet_cr0.25_0.npz", ELKUNet, {}, JELKUNet, {},
                translate_elkunet),
    "minkunet": ("minkunet_cr0.25.npz", MinkUNet, {}, JMinkUNet, {},
                 translate_minkunet),
    "elkencoder": ("elkencoder_cr0.25.npz", ELKEncoder, ENC_ARCH,
                   JELKEncoder, ENC_ARCH, translate_elkencoder),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _seg_inputs(family):
    """(feats, coords, nnz, reference state_dict) of the family's golden;
    ELKUNet's weights are in elkunet_cr0.25_state.npz."""
    g = np.load(os.path.join(GOLDENS, SEG[family][0]))
    n = len(g["coords"])
    c = np.full((CAPS[0], 4), -(2**20), np.int32)
    f = np.zeros((CAPS[0], 4), np.float32)
    c[:n], f[:n] = g["coords"], g["feats"]
    if family == "elkunet":
        sd = dict(np.load(os.path.join(GOLDENS, "elkunet_cr0.25_state.npz")))
    else:
        sd = {k[3:].replace("__", "."): np.array(g[k]) for k in g.files
              if k.startswith("sd_")}
    return f, c, n, sd


@pytest.mark.parametrize("family", sorted(SEG))
def test_seg_bfloat16_logits_match_jax_bfloat16(family):
    _, cls, kw, jcls, jkw, translate = SEG[family]
    f, c, n, sd = _seg_inputs(family)
    port = cls(20, cr=0.25, capacities=CAPS, dtype="bfloat16", device="cpu",
               **kw)
    load_reference_state_dict(port, {k: torch.from_numpy(np.array(v))
                                     for k, v in sd.items()})
    with torch.inference_mode():
        got = port.eval()(t_make(f, c, nnz=n, device="cpu"))
    got = got.float().numpy()[:n]
    jmodel = jcls(num_classes=20, cr=0.25, capacities=CAPS, dtype="bfloat16",
                  **jkw)
    want = np.asarray(jax.jit(lambda v, f, c, n: jmodel.apply(
        v, j_make(f, c, nnz=n), False))(translate(sd), f, c, n),
        np.float32)[:n]
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    err = _rel(got, want)
    assert err < SEG_TOL, err
    top2 = np.sort(want, -1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > SEG_TOL * np.abs(want).max()
    assert sure.mean() > 0.99
    np.testing.assert_array_equal(got[sure].argmax(-1),
                                  want[sure].argmax(-1))


@pytest.fixture(scope="module")
def det_outputs():
    """(port BEV, port head maps, JAX BEV, JAX head maps) of the tiny det
    VoxelNet in bfloat16 on shared weights."""
    sd = _reference_sd()
    batch = _tiny_batch()
    port = VoxelNet(capacities=DET_CAPS, grid_shape=GRID, dtype="bfloat16",
                    device="cpu")
    port.load_state_dict(_torch_sd(sd), strict=True)
    bev = {}
    port.backbone.register_forward_hook(
        lambda mod, args, out: bev.setdefault("port", out))
    with torch.inference_mode():
        preds = port.eval()(*tdp.det_inputs(batch, "cpu"))
    jmodel = JVoxelNet(num_input_features=5, batch_size=1, grid_shape=GRID,
                       capacities=DET_CAPS, dtype="bfloat16")
    jpreds, inter = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, False, capture_intermediates=lambda m, name:
        m.name == "backbone"))(translate_voxelnet(sd), batch["voxels"],
                               batch["coords"], batch["num_points"],
                               batch["nnz"])
    jbev = inter["intermediates"]["backbone"]["__call__"][0][0]
    return bev["port"], preds, jbev, jpreds


def test_det_bfloat16_bev_matches_jax_bfloat16(det_outputs):
    bev, _, jbev, _ = det_outputs
    got, want = bev.float().numpy(), np.asarray(jbev, np.float32)
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert _rel(got, want) < BEV_TOL


def test_det_bfloat16_head_maps_match_jax_bfloat16(det_outputs):
    _, preds, _, jpreds = det_outputs
    assert len(preds) == len(jpreds) == 6
    worst = 0.0
    for t, (g, w) in enumerate(zip(preds, jpreds)):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == torch.bfloat16
            err = _rel(g[k].float().numpy(), w[k])
            worst = max(worst, err)
            assert err < HEAD_TOL, (t, k, err)
    assert worst > 0
