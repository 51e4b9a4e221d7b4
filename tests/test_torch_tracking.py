"""Port vs JAX: tracking (`link_tpu_torch/tracking`, `tools/nusc_track`,
`tools/waymo_track`), exactly.

`greedy_assignment` and `hungarian_assignment` on gated random costs;
`CenterTracker` (greedy and Hungarian, with coasting, gating and a score
threshold) over random detection streams: every frame's tracks, their ids,
centres, ages and activity equal; `nusc_track` (`frames_from_infos`,
`run_tracking`, `main` on a submission JSON and an info pkl) and
`waymo_track` (`transform_box`, `main` on a detections pkl and the infos of
the port's `create_data_waymo` over a written tree) write the same files.
"""

import json
import os
import pickle
import sys

import numpy as np
import pytest

from link_tpu.tracking import tracker as JT
from link_tpu_torch.data import waymo as tw
from link_tpu_torch.tools import create_data_waymo as tcw
from link_tpu_torch.tools import nusc_track as tnt
from link_tpu_torch.tools import waymo_track as twt
from link_tpu_torch.tracking import tracker as TT
from test_torch_nuscenes_data import assert_same
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tools import nusc_track as jnt
from tools import waymo_track as jwt


def _costs(rng, n, m):
    d = rng.uniform(0, 10, (n, m))
    d[rng.random((n, m)) < 0.3] = 1e18
    return d


@pytest.mark.parametrize("seed", range(4))
def test_assignments_match_jax(seed):
    rng = np.random.default_rng(seed)
    for n, m in ((0, 3), (3, 0), (4, 4), (6, 3), (2, 7)):
        d = _costs(rng, n, m)
        assert_same(TT.greedy_assignment(d), JT.greedy_assignment(d))
        if n and m:
            assert_same(TT.hungarian_assignment(d),
                        JT.hungarian_assignment(d))


def _stream(rng, names, n_frames=8):
    """Objects moving at constant velocity, seen with noise, some frames
    missing an object, plus clutter of random classes and scores."""
    n = 6
    pos = rng.uniform(-30, 30, (n, 2))
    vel = rng.normal(0, 4, (n, 2))
    cls = rng.choice(names, n)
    frames = []
    for _ in range(n_frames):
        dets = []
        for i in range(n):
            if rng.random() < 0.15:
                continue
            dets.append({"translation": [*(pos[i] + rng.normal(0, 0.2, 2)),
                                         0.0],
                         "velocity": list(vel[i] + rng.normal(0, 0.3, 2)),
                         "size": [2.0, 4.0, 1.6],
                         "rotation": [1.0, 0.0, 0.0, 0.0],
                         "detection_name": str(cls[i]),
                         "detection_score": float(rng.uniform(0.05, 1))})
        for _ in range(int(rng.integers(0, 3))):
            dets.append({"translation": [*rng.uniform(-30, 30, 2), 0.0],
                         "velocity": list(rng.normal(0, 2, 2)),
                         "size": [1.0, 1.0, 1.0],
                         "rotation": [1.0, 0.0, 0.0, 0.0],
                         "detection_name": str(rng.choice(names + ["bus"])),
                         "detection_score": float(rng.uniform(0, 1))})
        frames.append(dets)
        pos = pos + 0.5 * vel
    return frames


@pytest.mark.parametrize("hungarian", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_center_tracker_matches_jax(hungarian, seed):
    rng = np.random.default_rng(seed)
    names = ["car", "pedestrian", "truck"]
    kw = dict(max_age=2, hungarian=hungarian, score_thresh=0.1 * seed)
    got_t, want_t = TT.CenterTracker(**kw), JT.CenterTracker(**kw)
    ids = set()
    for dets in _stream(rng, names):
        got = got_t.step([dict(d) for d in dets], 0.5)
        want = want_t.step([dict(d) for d in dets], 0.5)
        assert_same(got, want)
        ids |= {t["tracking_id"] for t in got if t["active"] > 1}
    assert ids, "no track lived past one frame"


def test_waymo_tracker_tables_match_jax():
    assert TT.WAYMO_TRACKING_NAMES == JT.WAYMO_TRACKING_NAMES
    assert TT.NUSC_TRACKING_NAMES == JT.NUSC_TRACKING_NAMES
    assert TT.NUSC_CLS_VELOCITY_ERROR == JT.NUSC_CLS_VELOCITY_ERROR


@pytest.fixture
def nusc_files(tmp_path):
    """A submission JSON over 3 scenes of 4 frames (timestamps in
    microseconds, a 20 s gap between scenes) and its info pkl."""
    rng = np.random.default_rng(5)
    infos, results = [], {}
    frames = _stream(rng, ["car", "pedestrian", "bicycle"], 12)
    for k, dets in enumerate(frames):
        token = f"tok{k:02d}"
        infos.append({"token": token,
                      "timestamp": int(1.5e15 + 2e7 * (k // 4)
                                       + 5e5 * (k % 4))})
        results[token] = [dict(d, sample_token=token) for d in dets]
    rng.shuffle(infos)
    info = tmp_path / "infos.pkl"
    with open(info, "wb") as f:
        pickle.dump(infos, f)
    sub = tmp_path / "sub.json"
    with open(sub, "w") as f:
        json.dump({"results": results}, f)
    return str(sub), str(info)


@pytest.mark.parametrize("hungarian", [False, True])
def test_nusc_track_matches_jax(nusc_files, tmp_path, monkeypatch,
                                hungarian):
    sub, info = nusc_files
    frames = tnt.frames_from_infos(info)
    assert_same(frames, jnt.frames_from_infos(info))
    assert sum(f["first"] for f in frames) == 3
    preds = json.load(open(sub))["results"]
    assert_same(tnt.run_tracking(preds, frames, 3, hungarian),
                jnt.run_tracking(preds, frames, 3, hungarian))
    extra = ["--hungarian"] if hungarian else []
    out = {}
    for name, main in (("jax", None), ("port", tnt.main)):
        argv = ["--detections", sub, "--info", info, "--work-dir",
                str(tmp_path / name), *extra]
        if main is None:
            monkeypatch.setattr(sys, "argv", ["nusc_track", *argv])
            jnt.main()
        else:
            assert main(argv) == 0
        with open(tmp_path / name / "tracking_result.json") as f:
            out[name] = json.load(f)
    assert out["port"] == out["jax"]
    assert any(out["port"]["results"].values())


def test_waymo_transform_box_matches_jax():
    rng = np.random.default_rng(3)
    boxes = rng.standard_normal((5, 9))
    pose = np.eye(4)
    th = 0.7
    pose[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
    pose[:3, 3] = [10, -4, 2]
    assert_same(twt.transform_box(boxes, pose), jwt.transform_box(boxes,
                                                                  pose))
    det = {"box3d_lidar": boxes, "label_preds": np.array([0, 1, 2, 0, 3]),
           "scores": rng.uniform(0, 1, 5)}
    assert_same(twt.to_global_dets(det, pose), jwt.to_global_dets(det, pose))


def test_waymo_track_matches_jax(tmp_path, monkeypatch):
    """The infos of a written tree (2 sequences of 3 frames) and random
    detections around its GT boxes: the same tracking results pkl."""
    root = str(tmp_path / "waymo")
    tw.write_synthetic_tree(root, 3, 3000, seed=2, split="val")
    tcw.main(["infos", "--root", root, "--split", "val"])
    info = os.path.join(root, "infos_val_01sweeps.pkl")
    rng = np.random.default_rng(4)
    dets = {}
    for inf in pickle.load(open(info, "rb")):
        gt = np.asarray(inf["gt_boxes"], np.float64)
        boxes = gt + rng.normal(0, 0.1, gt.shape)
        labels = np.array([tw.WAYMO_CLASSES.index(n)
                           for n in inf["gt_names"]])
        dets[inf["token"]] = {"box3d_lidar": boxes.astype(np.float32),
                              "label_preds": labels,
                              "scores": rng.uniform(0.5, 1, len(gt))}
    det_path = str(tmp_path / "dets.pkl")
    with open(det_path, "wb") as f:
        pickle.dump(dets, f)
    out = {}
    for name in ("jax", "port"):
        argv = ["--detections", det_path, "--info", info, "--work-dir",
                str(tmp_path / name)]
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["waymo_track", *argv])
            jwt.main()
        else:
            assert twt.main(argv) == 0
        with open(tmp_path / name / "tracking_result.pkl", "rb") as f:
            out[name] = pickle.load(f)
    assert_same(out["port"], out["jax"])
    assert len(out["port"]) == 6
    ids = [i for r in out["port"].values() for i in r["tracking_ids"]]
    assert len(ids) > len(set(ids))          # tracks carried across frames
