"""Port vs JAX: the detection serving path around the model.

Host-side NumPy copies (voxelizer, collate, synthetic frames, rotated NMS)
must give the JAX package's arrays exactly. The box decode runs the same
float32 formulas on the same maps: rel < 1e-6. `SingleFramePredictor` on a
tiny frame with shared weights: the same boxes (labels exact, boxes and
scores to 1e-4 absolute / relative: the two forwards differ by ~1e-6, and
no score lies that close to a threshold or floor in this frame).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from link_tpu import native
from link_tpu.data import det_pipeline as jdp
from link_tpu.data import nuscenes as jnus
from link_tpu.inference import SingleFramePredictor as JPredictor
from link_tpu.models.center_head import decode_boxes as j_decode
from link_tpu.ops import nms as jnms
from link_tpu.utils.torch_import_det import translate_voxelnet
from link_tpu_torch.data import det_pipeline as tdp
from link_tpu_torch.data import nuscenes as tnus
from link_tpu_torch.inference import SingleFramePredictor as TPredictor
from link_tpu_torch.models.scn import det_capacities
from link_tpu_torch.models.center_head import decode_boxes as t_decode
from link_tpu_torch.ops import nms as tnms
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = dict(pc_range=[-12, -12], voxel_size=[0.5, 0.5],
                post_center_limit_range=[-15, -15, -10, 15, 15, 10])


def _points(seed, n=3000):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-11, 11, (n, 5)).astype(np.float32)
    pts[:, 2] = rng.uniform(-4.9, 2.9, n)
    pts[:, 3] = rng.uniform(0, 255, n)
    return pts


@pytest.mark.parametrize("max_points,max_voxels", [(10, 4000), (3, 500)])
def test_voxelizer_and_collate_match_jax(max_points, max_voxels):
    """Same voxels, (z, y, x) coords, point counts, truncation and pack-key
    row order as the JAX package's voxelizer; same collated batch."""
    pts = _points(1)
    pts = np.concatenate([pts, pts[:700] + 0.01])   # shared voxels
    args = (pts, (0.5, 0.5, 0.2), (-12, -12, -5, 12, 12, 3), max_points,
            max_voxels)
    want = jdp.points_to_voxel(*args)
    got = tdp.points_to_voxel(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (len(got[0]) == max_voxels) == (max_voxels == 500)  # truncated
    sample = {"voxels": got[0], "coords_zyx": got[1], "num_points": got[2]}
    tb = tdp.collate_det([sample], 4096, max_points=max_points)
    jb = jdp.collate_det([sample], 4096, max_points=max_points)
    assert sorted(tb) == sorted(jb)
    for k in tb:
        np.testing.assert_array_equal(tb[k], jb[k])
    ins = tdp.det_inputs(tb, "cpu")
    assert [tuple(t.shape) for t in ins] == [
        (4096, max_points, 5), (4096, 4), (4096,), ()]


def test_synthetic_nuscenes_matches_jax():
    kw = dict(length=2, mode="val", seed=3, n_points=20000, max_voxels=15000)
    jds, tds = jnus.SyntheticNuScenes(**kw), tnus.SyntheticNuScenes(**kw)
    for i in range(2):
        a, b = jds[i], tds[i]
        assert len(b["voxels"]) == 15000
        for k in ("voxels", "coords_zyx", "num_points"):
            np.testing.assert_array_equal(b[k], a[k])
        assert b["token"] == a["token"]


@pytest.mark.parametrize("use_native", [False, True])
def test_rotate_nms_matches_jax(monkeypatch, use_native):
    """The NumPy copy against the JAX package's NumPy branch and against
    its native kernel."""
    if use_native and not native.available():
        pytest.skip("native NMS library not built")
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
    rng = np.random.default_rng(21)
    n = 300
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, :2] = rng.uniform(-10, 10, (n, 2))
    boxes[:, 2] = rng.uniform(-1, 1, n)
    boxes[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    scores = rng.random(n).astype(np.float32)
    for thresh, pre, post in ((0.2, 1000, 83), (0.5, 100, None),
                              (0.01, None, 10)):
        want = jnms.rotate_nms_pcdet(boxes, scores, thresh, pre, post)
        got = tnms.rotate_nms_pcdet(boxes, scores, thresh, pre, post)
        np.testing.assert_array_equal(got, want)
        assert len(got) > 5


def test_decode_boxes_matches_jax():
    rng = np.random.default_rng(8)
    chans = dict(reg=2, height=1, dim=3, rot=2, vel=2)
    ncls = [1, 2, 2, 1, 2, 2]
    preds = [{**{k: rng.standard_normal((1, 9, 7, c)).astype(np.float32)
                 for k, c in chans.items()},
              "hm": rng.standard_normal((1, 9, 7, nc)).astype(np.float32)}
             for nc in ncls]
    cfg = dict(TINY_CFG, out_size_factor=8, score_threshold=0.3,
               post_center_limit_range=[-8, -8, -1, 8, 8, 1])
    want = j_decode([{k: jnp.asarray(v) for k, v in p.items()}
                     for p in preds], cfg, ncls)
    got = t_decode([{k: torch.from_numpy(v) for k, v in p.items()}
                    for p in preds], cfg, ncls)
    for (gb, gs, gl, gm), (wb, ws, wl, wm) in zip(got, want):
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        assert gl.dtype == torch.int32 and 0 < int(gm.sum()) < gm.numel()


def test_predictor_matches_jax_predictor():
    """Shared weights: the port's seeded init (fan-in scaled), hm biases at
    0 so the scores spread around 0.5, away from the 0.1 threshold."""
    kw = dict(max_voxels=4000, capacity=4096, grid_shape=(48, 48, 40),
              test_cfg=TINY_CFG)
    sd = TPredictor(seed=1, device="cpu", **kw).model.state_dict()
    for k in sd:
        if k.endswith("hm.3.bias"):
            sd[k] = torch.zeros_like(sd[k])
    tp = TPredictor(state_dict=sd, device="cpu", **kw)
    jp = JPredictor(**kw)
    # the JAX predictor's model at the port's level capacities
    jp.model = jp.model.clone(capacities=det_capacities(kw["capacity"], 1))
    tr = translate_voxelnet({k: v.numpy() for k, v in sd.items()})
    jp._vars = True                      # skip its own init: shared weights
    jp._params, jp._bstats = tr["params"], tr["batch_stats"]
    pts = _points(2)
    want = jp.predict(pts)
    got = tp.predict(pts)
    assert len(got["scores"]) > 5
    np.testing.assert_array_equal(got["label_preds"], want["label_preds"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got["box3d_lidar"], want["box3d_lidar"],
                               rtol=1e-4, atol=1e-4)
    # the three stages compose to predict
    again = tp.postprocess(tp.forward(tp.voxelize(pts)))
    for k in got:
        np.testing.assert_array_equal(again[k], got[k])


def test_det_modules_import_neither_jax_nor_link_tpu():
    """The detection modules of the port, each imported alone in a fresh
    interpreter."""
    mods = ["link_tpu_torch.inference", "link_tpu_torch.models.voxelnet",
            "link_tpu_torch.models.scn", "link_tpu_torch.models.rpn",
            "link_tpu_torch.models.center_head",
            "link_tpu_torch.sparse.spconv_engine",
            "link_tpu_torch.data.det_pipeline", "link_tpu_torch.data.nuscenes",
            "link_tpu_torch.ops.nms", "link_tpu_torch.ops.box_np",
            "link_tpu_torch.native", "link_tpu_torch.tools.stream_inference"]
    code = ("import importlib, sys\n"
            "for m in sys.argv[1:]:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'link_tpu'))\n"
            "sys.exit('imported: ' + ', '.join(bad) if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code, *mods], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
