"""Detection checkpoint translation structure test (mirrors
test_torch_import.py): an emulated reference VoxelNet state_dict must map
exactly onto the flax VoxelNet variable tree."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from link_tpu.models.voxelnet import VoxelNet
from link_tpu.utils.torch_import_det import translate_voxelnet
from link_tpu.data import det_pipeline as dp
from test_torch_import import tree_paths
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def make_det_state_dict():
    rng = np.random.default_rng(0)
    sd = {}
    planes = [16, 32, 64, 128]

    def spconv_w(name, ci, co, kz=3, ky=3, kx=3, bias=False):
        sd[name + ".weight"] = rng.standard_normal(
            (co, kz, ky, kx, ci)).astype(np.float32) * 0.1
        if bias:
            sd[name + ".bias"] = np.zeros(co, np.float32)

    def bn(name, c):
        sd[name + ".weight"] = np.ones(c, np.float32)
        sd[name + ".bias"] = np.zeros(c, np.float32)
        sd[name + ".running_mean"] = np.zeros(c, np.float32)
        sd[name + ".running_var"] = np.ones(c, np.float32)

    def conv2d(name, ci, co, k=3, bias=False):
        sd[name + ".weight"] = rng.standard_normal(
            (co, ci, k, k)).astype(np.float32) * 0.1
        if bias:
            sd[name + ".bias"] = np.zeros(co, np.float32)

    spconv_w("backbone.conv_input.0", 5, 16)
    bn("backbone.conv_input.1", 16)
    for lvl in range(1, 5):
        c = planes[lvl - 1]
        if lvl > 1:
            spconv_w(f"backbone.down{lvl}.0", planes[lvl - 2], c)
            bn(f"backbone.down{lvl}.1", c)
        for bi in range(2):
            base = f"backbone.conv{lvl}.{bi}"
            spconv_w(base + ".conv1", c, c, bias=True)
            bn(base + ".bn1", c)
            spconv_w(base + ".conv2", c, c, bias=True)
            bn(base + ".bn2", c)
        spconv_w(f"backbone.conv{lvl}_tail.0", c, c)
        bn(f"backbone.conv{lvl}_tail.1", c)
        e = f"backbone.elk{lvl}"
        sd[e + ".pre_mix.0.weight"] = rng.standard_normal(
            (c, c)).astype(np.float32)
        sd[e + ".pre_mix.1.weight"] = np.ones(c, np.float32)
        sd[e + ".pre_mix.1.bias"] = np.zeros(c, np.float32)
        sd[e + ".local_mix.0.kernel"] = rng.standard_normal(
            (27, c, c)).astype(np.float32) * 0.1
        sd[e + ".pos_weight.0.weight"] = rng.standard_normal(
            (c, 3)).astype(np.float32)
        for nm in ("norm", "norm_local"):
            sd[f"{e}.{nm}.weight"] = np.ones(c, np.float32)
            sd[f"{e}.{nm}.bias"] = np.zeros(c, np.float32)
        spconv_w(f"backbone.elk{lvl}_tail.0", c, c)
        bn(f"backbone.elk{lvl}_tail.1", c)
    spconv_w("backbone.extra_conv.0", 128, 128, kz=3, ky=1, kx=1)
    bn("backbone.extra_conv.1", 128)

    # RPN
    fin = [256, 128]
    filt = [128, 256]
    for blk in range(2):
        conv_ids = [1] + [4 + 3 * j for j in range(5)]
        ci = fin[blk]
        for j, tid in enumerate(conv_ids):
            conv2d(f"neck.blocks.{blk}.{tid}", ci if j == 0 else filt[blk],
                   filt[blk])
            bn(f"neck.blocks.{blk}.{tid + 1}", filt[blk])
    # deblock0: Conv k=1; deblock1: ConvTranspose k=2
    conv2d("neck.deblocks.0.0", 128, 256, k=1)
    bn("neck.deblocks.0.1", 256)
    sd["neck.deblocks.1.0.weight"] = rng.standard_normal(
        (256, 256, 2, 2)).astype(np.float32) * 0.1
    bn("neck.deblocks.1.1", 256)

    # CenterHead
    conv2d("bbox_head.shared_conv.0", 512, 64, bias=True)
    bn("bbox_head.shared_conv.1", 64)
    chans = dict(reg=2, height=1, dim=3, rot=2, vel=2)
    ncls = [1, 2, 2, 1, 2, 2]
    for t in range(6):
        for head, co in list(chans.items()) + [("hm", ncls[t])]:
            base = f"bbox_head.tasks.{t}.{head}"
            conv2d(base + ".0", 64, 64, bias=True)
            bn(base + ".1", 64)
            conv2d(base + ".3", 64, co, bias=True)
    return sd


@pytest.mark.slow           # ~2 min full-model init compile; numeric det
# translation coverage stays in the default profile via
# test_golden_parity.py::test_tselk_block_matches_reference
def test_det_translation_matches_flax_tree():
    sd = make_det_state_dict()
    translated = translate_voxelnet(sd)

    rng = np.random.default_rng(1)
    pr = (-12, -12, -2, 12, 12, 2)
    pts = rng.uniform(-11, 11, (2000, 5)).astype(np.float32)
    voxels, coors, nppv = dp.points_to_voxel(pts, (0.5, 0.5, 0.1), pr,
                                             max_points=5, max_voxels=3000)
    batch = dp.collate_det([{"voxels": voxels, "coords_zyx": coors,
                             "num_points": nppv}], 3072, max_points=5)

    model = VoxelNet(num_input_features=5, batch_size=1,
                     grid_shape=(48, 48, 40),
                     capacities=(3072, 2048, 1024, 512))
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.asarray(batch["voxels"]),
                           jnp.asarray(batch["coords"]),
                           jnp.asarray(batch["num_points"]),
                           jnp.asarray(batch["nnz"]), False)

    want_p = tree_paths(jax.tree_util.tree_map(np.asarray,
                                               variables["params"]))
    got_p = tree_paths(translated["params"])
    assert set(got_p) == set(want_p), (
        f"missing={sorted(set(want_p) - set(got_p))[:8]} "
        f"extra={sorted(set(got_p) - set(want_p))[:8]}")
    for k in want_p:
        assert got_p[k] == want_p[k], (k, got_p[k], want_p[k])

    want_s = tree_paths(jax.tree_util.tree_map(np.asarray,
                                               variables["batch_stats"]))
    got_s = tree_paths(translated["batch_stats"])
    assert set(got_s) == set(want_s), (
        f"missing={sorted(set(want_s) - set(got_s))[:8]} "
        f"extra={sorted(set(got_s) - set(want_s))[:8]}")

    preds = model.apply(translated, jnp.asarray(batch["voxels"]),
                        jnp.asarray(batch["coords"]),
                        jnp.asarray(batch["num_points"]),
                        jnp.asarray(batch["nnz"]), False)
    assert np.isfinite(np.asarray(preds[0]["hm"])).all()
