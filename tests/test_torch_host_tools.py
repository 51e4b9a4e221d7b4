"""The port's host tools on the CPU: `utils/profiling`, the logger's
tensorboard events, `tools/demo` and `tools/profile_fwd`.

- `IterTimer` against the JAX package's on the same clock readings;
- `TensorboardLogger` writes an event file (the `tensorboard` package is
  here), and is inactive, writing nothing, when the import fails;
- `profiling.trace` of a tiny seg forward on the CPU, read back by
  `trace_device_ms_by_source`, holds the port's `record_function` scopes;
- `flops_of` equals the hand count on a tiny conv stack: PyTorch's own
  product count plus 2 K M Ci Co for each `gather_conv` call;
- `demo` on a `det_test --save-vis` pickle (the tiny det grid of
  tests/test_torch_det_test_tool.py) writes a PNG per frame, and its
  `box_corners_bev` equals the JAX tool's;
- `profile_fwd --device cpu` at a tiny size, seg and det, forward and
  training step.
"""

import functools
import glob
import os
import pickle

import numpy as np
import pytest
import torch

from link_tpu.utils import profiling as JP
from link_tpu_torch.data import det_pipeline as dp
from link_tpu_torch.data.nuscenes import SyntheticNuScenes
from link_tpu_torch.nn.modules import Linear, SparseConv3d
from link_tpu_torch.sparse.coords import JOIN_RANGE
from link_tpu_torch.sparse.tensor import make_sparse_tensor
from link_tpu_torch.tools import demo, profile_fwd
from link_tpu_torch.utils import logging as TL
from link_tpu_torch.utils import profiling as TP
from test_torch_det_test_tool import _test, tiny, tree  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tools import demo as jdemo


def test_iter_timer_matches_jax(monkeypatch):
    clock = iter(np.cumsum(np.random.default_rng(0).uniform(0, 1, 200)))
    readings = [float(next(clock)) for _ in range(200)]
    out = []
    for mod in (TP, JP):
        it = iter(readings)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(it))
        timer = mod.IterTimer(warmup=2)
        for _ in range(9):
            timer.tic_data()
            timer.toc_data()
            timer.toc_step()
        out.append(timer.summary())
        monkeypatch.undo()
    assert out[0] == out[1] and out[0]["step_time"] > 0


def test_tensorboard_logger_writes_events(tmp_path):
    tb = TL.TensorboardLogger(str(tmp_path))
    assert tb.active
    tb.scalars({"loss/train": 1.5, "note": "not a number"}, 1)
    tb.flush()
    events = glob.glob(str(tmp_path / "tensorboard" / "events.out.*"))
    assert len(events) == 1 and os.path.getsize(events[0]) > 0


def test_tensorboard_logger_is_inactive_without_the_package(tmp_path,
                                                            monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard",
                        None)
    tb = TL.TensorboardLogger(str(tmp_path))
    assert not tb.active
    tb.scalars({"loss/train": 1.0}, 1)
    tb.flush()
    assert not os.path.exists(tmp_path / "tensorboard")


def _tiny_stack(seed=0):
    """Two K = 27 sparse convs (4 -> 8 -> 6) and a linear head over 300
    random voxels at capacity 512."""
    rng = np.random.default_rng(seed)
    coords = np.unique(rng.integers(0, 12, (300, 3)), axis=0)
    n = len(coords)
    cap = 512
    c = np.full((cap, 4), -1, np.int32)
    c[:n, :3] = coords
    c[:n, 3] = 0
    order = np.lexsort((c[:n, 0], c[:n, 1], c[:n, 2]))
    c[:n] = c[:n][order]
    feats = np.zeros((cap, 4), np.float32)
    feats[:n] = rng.normal(size=(n, 4))
    gen = torch.Generator().manual_seed(seed)
    convs = [SparseConv3d(4, 8, 3, device="cpu", generator=gen),
             SparseConv3d(8, 6, 3, device="cpu", generator=gen)]
    head = Linear(6, 3, device="cpu", generator=gen)

    def run():
        st = make_sparse_tensor(feats, c, nnz=n, device="cpu")
        for conv in convs:
            st = conv(st)
        return head(st.feats)
    return run, cap


def test_flops_of_equals_the_hand_count():
    run, cap = _tiny_stack()
    got = TP.flops_of(run)
    # the two convs' gather form over every row, then the head's matmul
    want = 2 * 27 * cap * (4 * 8 + 8 * 6) + 2 * cap * 6 * 3
    assert got == want


def test_trace_holds_the_ports_scopes(tmp_path):
    run, _ = _tiny_stack(1)
    with TP.trace(str(tmp_path), "cpu"):
        run()
    stats = TP.trace_device_ms_by_source(str(tmp_path))
    assert stats["device"] == "cpu"
    assert JOIN_RANGE in stats["by_scope"] and stats["by_scope"][
        JOIN_RANGE] > 0
    assert stats["launches"].get("aten::mm", 0) >= 1
    assert TP.trace_device_ms_by_source(str(tmp_path / "none"))[
        "device"] is None


def test_demo_draws_a_det_test_vis_pickle(tree, tiny, tmp_path):  # noqa: F811
    vis = str(tmp_path / "vis.pkl")
    _test(tree, "--save-vis", vis)
    with open(vis, "rb") as f:
        frames = pickle.load(f)
    assert len(frames) == 2 and all(len(fr["points"]) for fr in frames)
    out = tmp_path / "png"
    assert demo.main(["--vis", vis, "--out-dir", str(out), "--thresh",
                      "0.0"]) == 0
    pngs = sorted(os.listdir(out))
    assert pngs == ["file00.png", "file01.png"]
    assert all(os.path.getsize(out / p) > 1000 for p in pngs)
    boxes = frames[0]["detections"]["box3d_lidar"]
    if len(boxes) == 0:
        boxes = frames[0]["gt_boxes"]
    np.testing.assert_array_equal(demo.box_corners_bev(boxes),
                                  jdemo.box_corners_bev(boxes))
    syn = demo.synthetic_frame(3)
    np.testing.assert_array_equal(syn["points"],
                                  jdemo.synthetic_frame(3)["points"])
    np.testing.assert_array_equal(demo.box_corners_bev(syn["gt_boxes"]),
                                  jdemo.box_corners_bev(syn["gt_boxes"]))


@pytest.fixture
def tiny_profile(monkeypatch):
    P = profile_fwd
    monkeypatch.setattr(P, "DET_GRID", (48, 48, 40))
    monkeypatch.setattr(P, "DET_CAP", 4096)
    monkeypatch.setattr(P, "DET_MAX_VOXELS", 4000)
    monkeypatch.setattr(P, "DET_TEST_CFG", dict(
        P.DET_TEST_CFG, pc_range=[-12, -12], voxel_size=[0.5, 0.5],
        post_center_limit_range=[-15, -15, -10, 15, 15, 10]))
    monkeypatch.setattr(P, "SyntheticNuScenes", functools.partial(
        SyntheticNuScenes, n_points=3000, pc_range=(-12, -12, -2, 12, 12, 2),
        voxel_size=(0.5, 0.5, 0.1)))
    monkeypatch.setattr(P, "SEG_CAPS", (384, 192, 96, 48, 24))
    monkeypatch.setattr(P, "SEG_CR", 0.125)
    monkeypatch.setattr(P, "SEG_VOXELS", 300)
    monkeypatch.setattr(P, "SEG_RAW_POINTS", 2000)
    monkeypatch.setattr(P, "SEG_VOXEL_SIZE", 0.4)


@pytest.mark.parametrize("flags,scope", [
    ([], JOIN_RANGE), (["--train"], "seg_train/backward"),
    (["--det"], JOIN_RANGE), (["--det", "--train"], "det_train/forward")])
def test_profile_fwd_runs_on_the_cpu(tiny_profile, tmp_path, capsys, flags,
                                     scope):
    assert profile_fwd.main(["--device", "cpu", "--iters", "1", "--top",
                             "5", "--trace-dir", str(tmp_path)] + flags) == 0
    text = capsys.readouterr().out
    assert "== by scope" in text and f"  {scope}" in text
    assert "== by kernel" in text and "first call" in text
