"""Port vs JAX: det serving's host side.

The port's native library (`link_tpu_torch/native`, a copy of
`link_tpu/native`'s C++ built by the port) against the JAX package's, in
the same process and on the same numpy inputs:

  * the voxelizer (`voxelize_points`, `voxelize_collated`, and
    `points_to_voxel` with impl "native" and "numpy"): exactly equal to JAX's
    native library and to its NumPy path, truncating and not, and on an
    empty cloud; concurrent calls (ctypes releases the GIL) equal serial
    ones;
  * the host rotated NMS (`rotate_nms_pcdet`, impl "native"): the same kept
    indices at the three settings of the serving tests; `bev_iou` and
    `iou3d` bit for bit (the same C++ on the same inputs);
  * `SingleFramePredictor` with host NMS on the tiny frame of
    test_torch_det_serving.py with shared weights: labels exact, boxes and
    scores to 1e-4 absolute / relative (the two forwards differ by ~1e-6);
    the port's native and NumPy host paths give equal outputs;
  * a checkpoint round trip gives the same outputs, and `config=` maps the
    ELKv3 nuScenes config as the JAX predictor does;
  * the streaming tool writes one well-formed record per frame;
  * without a compiler, or with a source that does not compile, the native
    loader raises instead of handing back NumPy results.

The JAX package's library is asked for when the module's first test runs,
not at collection. Its loader builds `libnms.so` with g++ straight into the
final path and remembers a failed load; when another test process is
building it at that moment, the load of the half-written file fails, so the
fixture clears that memory and retries for up to LOAD_WAIT_S. A library
that still does not load fails the module's tests with the loader's error;
none is skipped.
"""

import concurrent.futures as cf
import ctypes
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from link_tpu import native as jnative
from link_tpu.data import det_pipeline as jdp
from link_tpu.inference import SingleFramePredictor as JPredictor
from link_tpu.ops import nms as jnms
from link_tpu.utils.torch_import_det import translate_voxelnet
from link_tpu_torch import native
from link_tpu_torch.data import det_pipeline as tdp
from link_tpu_torch.inference import SingleFramePredictor as TPredictor
from link_tpu_torch.models.scn import det_capacities
from link_tpu_torch.ops import nms as tnms
from link_tpu_torch.tools import stream_inference
from link_tpu_torch.train.checkpoint import save_checkpoint
from link_tpu_torch.train.trainer import TrainState, make_sgd
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ELKV3 = os.path.join(REPO, "configs", "nusc", "voxelnet",
                     "nusc_centerpoint_voxelnet_0075voxel_fix_bn_z_elkv3.py")
VS = (0.25, 0.25, 0.2)                     # tests/test_native_voxelize.py
PR = (-20.0, -20.0, -3.0, 20.0, 20.0, 3.0)
GRID = np.array([160, 160, 30], np.int32)
TINY_CFG = dict(pc_range=[-12, -12], voxel_size=[0.5, 0.5],
                post_center_limit_range=[-15, -15, -10, 15, 15, 10])
TINY = dict(max_voxels=4000, capacity=4096, grid_shape=(48, 48, 40),
            test_cfg=TINY_CFG)

LOAD_WAIT_S = 120.0     # a concurrent first build: ~10 s of g++


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    """The JAX package's native library, loaded (and built on first use)
    when the module's first test runs; see the module docstring."""
    deadline = time.monotonic() + LOAD_WAIT_S
    while not jnative.available():
        if time.monotonic() > deadline:
            so = os.path.join(os.path.dirname(jnative.__file__), "libnms.so")
            try:
                ctypes.CDLL(so)
                why = "it loads now, after the deadline"
            except OSError as e:
                why = str(e)
            pytest.fail(f"the JAX package's native library {so} did not "
                        f"load within {LOAD_WAIT_S:.0f} s: {why}")
        time.sleep(0.5)
        jnative._TRIED = False      # forget the failed load and try again


def _cloud(seed, n=60000):
    """The clouds of tests/test_native_voxelize.py."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-21, 21, (n, 3)),
                           rng.uniform(0, 1, (n, 2))],
                          axis=1).astype(np.float32)


def _jax_numpy_voxelize(monkeypatch, *args):
    with monkeypatch.context() as m:
        m.setattr(jnative, "available", lambda: False)
        return jdp.points_to_voxel(*args)


@pytest.mark.parametrize("n,max_points,max_voxels", [
    (60000, 6, 4096),          # truncates: ~7,900 voxels in range
    (60000, 10, 8192),         # keeps every voxel
    (0, 5, 100)])              # an empty cloud
def test_voxelizer_matches_jax(monkeypatch, n, max_points, max_voxels):
    pts = _cloud(0, n)
    args = (pts, VS, PR, max_points, max_voxels)
    want = jnative.voxelize_points(pts, VS, PR, GRID, max_points, max_voxels)
    for got in (native.voxelize_points(pts, VS, PR, GRID, max_points,
                                       max_voxels),
                tdp.points_to_voxel(*args),
                tdp.points_to_voxel(*args, impl="numpy"),
                _jax_numpy_voxelize(monkeypatch, *args)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert (len(want[0]) == max_voxels) == (max_voxels == 4096)
    cap = max_voxels + 7
    got = native.voxelize_collated(pts, VS, PR, GRID, max_points, max_voxels,
                                   cap)
    jb = jnative.voxelize_collated(pts, VS, PR, GRID, max_points, max_voxels,
                                   cap)
    sample = {"voxels": want[0], "coords_zyx": want[1],
              "num_points": want[2]}
    collated = tdp.collate_det([sample], cap, max_points=max_points)
    assert sorted(got) == sorted(jb) == sorted(collated)
    for k in got:
        np.testing.assert_array_equal(got[k], jb[k])
        np.testing.assert_array_equal(got[k], collated[k])


def test_voxelizer_rejects_an_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        tdp.points_to_voxel(_cloud(0, 10), VS, PR, impl="fast")


def test_concurrent_calls_match_serial():
    clouds = [_cloud(s, 40000) for s in range(8)]

    def run(p):
        return native.voxelize_points(p, VS, PR, GRID, 5, 4096)

    serial = [run(p) for p in clouds]
    for _ in range(3):                     # repeat to give races a chance
        with cf.ThreadPoolExecutor(max_workers=4) as ex:
            conc = list(ex.map(run, clouds))
        for s, c in zip(serial, conc):
            for a, b in zip(s, c):
                np.testing.assert_array_equal(a, b)


def _boxes7(n=300, seed=21):
    """The boxes and scores of test_torch_det_serving.py's NMS test."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, :2] = rng.uniform(-10, 10, (n, 2))
    boxes[:, 2] = rng.uniform(-1, 1, n)
    boxes[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return boxes, rng.random(n).astype(np.float32)


@pytest.mark.parametrize("thresh,pre,post", [(0.2, 1000, 83),
                                             (0.5, 100, None),
                                             (0.01, None, 10)])
def test_native_rotate_nms_matches_jax(thresh, pre, post):
    boxes, scores = _boxes7()
    want = jnms.rotate_nms_pcdet(boxes, scores, thresh, pre, post)
    got = tnms.rotate_nms_pcdet(boxes, scores, thresh, pre, post)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tnms.rotate_nms_pcdet(boxes, scores, thresh, pre, post,
                              impl="numpy"), want)
    assert got.dtype == np.int64 and len(got) > 5
    assert len(tnms.rotate_nms_pcdet(boxes[:0], scores[:0], thresh)) == 0


def test_bev_iou_and_iou3d_match_jax_bit_for_bit():
    boxes, _ = _boxes7(120, seed=3)
    a, b = boxes[:70], boxes[50:]
    for fn in ("bev_iou", "iou3d"):
        got = getattr(native, fn)(a, b)
        want = getattr(jnative, fn)(a, b)
        assert got.shape == (70, 70) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert 0 < np.count_nonzero(got) < got.size


def _points(seed, n=3000):
    """The tiny frame of test_torch_det_serving.py."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-11, 11, (n, 5)).astype(np.float32)
    pts[:, 2] = rng.uniform(-4.9, 2.9, n)
    pts[:, 3] = rng.uniform(0, 255, n)
    return pts


def _shared_weights():
    """The port's seeded init with the hm biases at 0, so that the scores
    spread around 0.5, away from the 0.1 threshold."""
    sd = TPredictor(seed=1, device="cpu", **TINY).model.state_dict()
    for k in sd:
        if k.endswith("hm.3.bias"):
            sd[k] = torch.zeros_like(sd[k])
    return sd


def _assert_same_detections(got, want, exact=False):
    assert len(got["scores"]) > 5
    np.testing.assert_array_equal(got["label_preds"], want["label_preds"])
    tol = 0 if exact else 1e-4
    for k in ("scores", "box3d_lidar"):
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol)


def test_predictor_with_host_nms_matches_jax_and_the_numpy_path():
    sd = _shared_weights()
    tp = TPredictor(state_dict=sd, device="cpu", **TINY)
    jp = JPredictor(**TINY)
    # the JAX predictor's model at the port's level capacities
    jp.model = jp.model.clone(capacities=det_capacities(TINY["capacity"], 1))
    tr = translate_voxelnet({k: v.detach().clone().numpy()
                             for k, v in sd.items()})
    jp._vars = True                      # skip its own init: shared weights
    jp._params, jp._bstats = tr["params"], tr["batch_stats"]
    pts = _points(2)
    got = tp.predict(pts)
    _assert_same_detections(got, jp.predict(pts))
    twin = TPredictor(state_dict=sd, device="cpu", host_impl="numpy", **TINY)
    for k, v in tp.voxelize(pts).items():
        np.testing.assert_array_equal(twin.voxelize(pts)[k], v)
    _assert_same_detections(twin.predict(pts), got, exact=True)
    # an empty cloud runs through both host paths alike (the biases alone
    # give the head's maps)
    empty = np.zeros((0, 4), np.float32)
    _assert_same_detections(twin.predict(empty), tp.predict(empty),
                            exact=True)


def test_checkpoint_round_trip_and_config(tmp_path):
    src = TPredictor(seed=4, device="cpu", **TINY)
    opt = make_sgd(src.model.parameters(), lr=0.1)
    path = save_checkpoint(str(tmp_path), TrainState(src.model, opt, step=3),
                           epoch=1)
    loaded = TPredictor(checkpoint=path, seed=9, device="cpu", **TINY)
    pts = _points(5)
    want = src.predict(pts)
    got = loaded.predict(pts)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        TPredictor(checkpoint=path, state_dict=src.model.state_dict(),
                   device="cpu", **TINY)
    bad = dict(torch.load(path, weights_only=True))
    bad["model"] = {k: v for k, v in bad["model"].items()
                    if "shared_conv" not in k}
    torch.save(bad, tmp_path / "partial.pt")
    with pytest.raises(RuntimeError, match="Missing key"):
        TPredictor(checkpoint=str(tmp_path / "partial.pt"), device="cpu",
                   **TINY)
    # config= on the ELKv3 nuScenes config gives the JAX predictor's cfg
    tcfg = TPredictor(config=ELKV3, device="cpu", capacity=4096,
                      max_voxels=4000, grid_shape=(48, 48, 40)).cfg
    jcfg = JPredictor(config=ELKV3).cfg
    assert tcfg == jcfg and tcfg["nms_iou_threshold"] == 0.2


def test_stream_tool_writes_one_record_per_frame(tmp_path):
    out = tmp_path / "dets.jsonl"
    stream_inference.main(["--tiny", "--synthetic", "2", "--device", "cpu",
                           "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["token"] for r in recs] == ["synthetic_0", "synthetic_1"]
    for r in recs:
        assert sorted(r) == ["boxes", "labels", "latency_ms", "scores",
                             "token"]
        assert r["latency_ms"] > 0
        assert len(r["boxes"]) == len(r["scores"]) == len(r["labels"])
        assert all(len(b) == 9 for b in r["boxes"])
        assert all(np.isfinite(r["scores"]))


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """The native loader with no library loaded and an empty build dir."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_native_loader_raises_without_a_compiler(monkeypatch, fresh_build):
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tdp.points_to_voxel(_cloud(0, 100), VS, PR)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnms.rotate_nms_pcdet(*_boxes7(20), 0.2)
    assert not (fresh_build / "build").exists()


def test_native_loader_raises_when_the_build_fails(monkeypatch, fresh_build):
    src = fresh_build / "src"
    shutil.copytree(native.SRC_DIR, src, ignore=shutil.ignore_patterns(
        "*.py", "__pycache__"))
    with open(src / "nms.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(native, "SRC_DIR", src)
    boxes = _boxes7(4)[0]
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as exc:
        native.bev_iou(boxes, boxes)
    assert "error" in str(exc.value)
    assert list((fresh_build / "build").iterdir()) == []
