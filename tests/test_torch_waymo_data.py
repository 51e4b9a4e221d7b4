"""Port vs JAX: the Waymo data (`link_tpu_torch/data/waymo.py`,
`link_tpu_torch/tools/create_data_waymo.py`).

Host-side NumPy copies, so every comparison is exact (the same arrays, the
same random stream per seed): `fill_infos` (nsweeps 1 and 2), `gt_db`,
`load_waymo_sweeps` and `WaymoDataset` in val mode and in train mode with
GT-AUG, on a tree of the port's `write_synthetic_tree` (small point count)
and on the tree of tests/test_waymo.py's `_make_tree`; and `decode` of the
fabricated toolkit's TFRecords (tests/fake_waymo.py) writes the same
pickles from both converters.
"""

import os
import pickle
import shutil
import sys

import numpy as np
import pytest

import fake_waymo
from link_tpu.data import gt_aug as jgt
from link_tpu.data import waymo as jw
from link_tpu_torch.data import gt_aug as tgt
from link_tpu_torch.data import waymo as tw
from link_tpu_torch.tools import create_data_waymo as tcw
from test_torch_nuscenes_data import assert_same
from test_waymo import _make_tree
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import create_data_waymo as jcw  # noqa: E402

# the reference Waymo config's GT-AUG groups (waymo_centerpoint_voxelnet_*)
SAMPLE_GROUPS = {"VEHICLE": 15, "PEDESTRIAN": 10, "CYCLIST": 10}
MIN_POINTS = {k: 5 for k in SAMPLE_GROUPS}
POINTS = 3000


class Args:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _both(tmp, make):
    """The same tree under <tmp>/jax and <tmp>/port."""
    roots = {k: str(tmp / k) for k in ("jax", "port")}
    make(roots["jax"])
    shutil.copytree(roots["jax"], roots["port"])
    return roots


@pytest.fixture(scope="module", params=["written", "make_tree"])
def tree(request, tmp_path_factory):
    """A tree in the decoded layout, prepared by each package's converter
    in its own copy: infos with 1 and 2 sweeps, and the GT database."""
    tmp = tmp_path_factory.mktemp("waymo_" + request.param)
    if request.param == "written":
        roots = _both(tmp, lambda r: tw.write_synthetic_tree(
            r, 3, POINTS, seed=4, sequences=2))
    else:
        roots = _both(tmp, _make_tree)
    for ns in (1, 2):
        jcw.fill_infos(Args(root=roots["jax"], split="train", nsweeps=ns))
        tcw.main(["infos", "--root", roots["port"], "--nsweeps", str(ns)])
    jcw.gt_db(Args(root=roots["jax"], split="train", nsweeps=1))
    tcw.main(["gt-db", "--root", roots["port"]])
    return dict(roots, kind=request.param)


def _load(root, name):
    with open(os.path.join(root, name), "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("nsweeps", [1, 2])
def test_fill_infos_matches_jax(tree, nsweeps):
    name = f"infos_train_{nsweeps:02d}sweeps.pkl"
    got, want = _load(tree["port"], name), _load(tree["jax"], name)
    assert len(want) >= 3
    assert_same(got, want, name)


def test_gt_db_matches_jax(tree):
    got = _load(tree["port"], "dbinfos_train.pkl")
    want = _load(tree["jax"], "dbinfos_train.pkl")
    assert_same(got, want, "dbinfos")
    assert sum(len(v) for v in want.values()) > 0
    for infos in want.values():
        for info in infos:
            a, b = (np.fromfile(os.path.join(tree[k], info["path"]),
                                np.float32) for k in ("port", "jax"))
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nsweeps", [1, 2])
def test_load_waymo_sweeps_matches_jax(tree, nsweeps):
    root = tree["port"]
    for info in _load(root, f"infos_train_{nsweeps:02d}sweeps.pkl"):
        got = tw.load_waymo_sweeps(info, root, nsweeps)
        want = jw.load_waymo_sweeps(info, root, nsweeps)
        assert_same(got, want)
        assert got["points"].shape[1] == (6 if nsweeps > 1 else 5)


@pytest.mark.parametrize("nsweeps", [1, 2])
def test_val_dataset_matches_jax(tree, nsweeps):
    root = tree["port"]
    path = os.path.join(root, f"infos_train_{nsweeps:02d}sweeps.pkl")
    got_ds = tw.WaymoDataset(path, root, mode="val", nsweeps=nsweeps)
    want_ds = jw.WaymoDataset(path, root, mode="val", nsweeps=nsweeps)
    for i in range(len(want_ds)):
        got = got_ds[i]
        assert_same(got, want_ds[i])
        assert len(got["voxels"]) > 0 and "gt_num_pts" in got


def test_train_dataset_with_gt_aug_matches_jax(tree):
    """Train mode from one seeded stream, GT-AUG on (each package's
    sampler over the same database), twice over the frames: voxels,
    boxes, classes and the three tasks' targets equal; samples pasted in
    the written frames. `_make_tree`'s boxes hold under 5 of its scattered
    points, so its database is sampled without the 5-point floor; its
    frames put every box where its database's boxes are, so none is
    pasted there."""
    root = tree["port"]
    path = os.path.join(root, "infos_train_01sweeps.pkl")
    db = os.path.join(root, "dbinfos_train.pkl")
    kw = dict(sample_groups=SAMPLE_GROUPS,
              min_points=(MIN_POINTS if tree["kind"] == "written"
                          else {k: 0 for k in MIN_POINTS}))
    got_ds = tw.WaymoDataset(path, root, mode="train", seed=6,
                             db_sampler=tgt.DataBaseSampler(db, root, **kw))
    want_ds = jw.WaymoDataset(path, root, mode="train", seed=6,
                              db_sampler=jgt.DataBaseSampler(db, root, **kw))
    pasted = 0
    for _ in range(2):
        for i in range(len(want_ds)):
            got = got_ds[i]
            assert_same(got, want_ds[i])
            assert len(got["targets"]["hm"]) == 3
            names = np.asarray(got_ds.infos[i]["gt_names"])
            pasted += len(got["gt_boxes"]) - int(np.isin(
                names, tw.WAYMO_CLASSES).sum())
    assert pasted > 0 or tree["kind"] == "make_tree"


def test_decode_writes_the_jax_converters_pickles(tmp_path, monkeypatch):
    """The fabricated toolkit's TFRecords (real record framing) through
    both converters' `decode`: the same frame and annos pickles."""
    fake_waymo.install(monkeypatch)
    records = str(tmp_path / "records")
    fake_waymo.build_world(records)
    glob_ = os.path.join(records, "*.tfrecord")
    jcw.decode(Args(records=glob_, out=str(tmp_path / "jax"),
                    split="train"))
    tcw.main(["decode", "--records", glob_, "--out", str(tmp_path / "port")])
    for sub in ("lidar", "annos"):
        d = tmp_path / "jax" / "train" / sub
        names = sorted(os.listdir(d))
        assert names == sorted(os.listdir(tmp_path / "port" / "train" / sub))
        assert len(names) == 6
        for n in names:
            assert_same(_load(str(tmp_path / "port" / "train" / sub), n),
                        _load(str(d), n), f"{sub}/{n}")


def test_decode_without_the_toolkit_exits_as_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    monkeypatch.setitem(sys.modules, "tensorflow.compat", None)
    monkeypatch.setitem(sys.modules, "tensorflow.compat.v2", None)
    msgs = []
    for run in (lambda: jcw.decode(Args(records="x", out=str(tmp_path),
                                        split="train")),
                lambda: tcw.main(["decode", "--records", "x", "--out",
                                  str(tmp_path)])):
        with pytest.raises(SystemExit) as e:
            run()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "waymo-open-dataset" in msgs[0]


def test_write_synthetic_tree_schema(tmp_path):
    """The decode schema: frame and annos pickles per (sequence, frame),
    exactly `points_per_frame` points in the detection range, the three
    classes with raw boxes and point counts, the vehicle pose moving
    frame to frame, timestamps 0.1 s apart."""
    paths = tw.write_synthetic_tree(str(tmp_path), 2, POINTS, seed=0,
                                    split="val", sequences=2)
    assert [os.path.basename(p) for p in paths] == [
        f"seq_{s}_frame_{f}.pkl" for s in range(2) for f in range(2)]
    times = []
    for p in paths:
        fr = _load(os.path.dirname(p), os.path.basename(p))
        an = _load(os.path.dirname(p).replace("lidar", "annos"),
                   os.path.basename(p))
        xyz = fr["lidars"]["points_xyz"]
        assert xyz.shape == (POINTS, 3) and xyz.dtype == np.float32
        assert fr["lidars"]["points_feature"].shape == (POINTS, 2)
        assert (np.abs(xyz[:, :2]) < 75.2).all()
        assert ((xyz[:, 2] > -2) & (xyz[:, 2] < 4)).all()
        for k in ("scene_name", "frame_name", "frame_id", "veh_to_global"):
            assert_same(an[k], fr[k], k)
        labels = {o["label"] for o in an["objects"]}
        assert labels <= {1, 2, 4} and 1 in labels
        assert all(o["box"].shape == (9,) for o in an["objects"])
        assert any(o["num_points"] > 0 for o in an["objects"])
        times.append(int(fr["frame_name"].split("_")[-1]))
    assert times[1] - times[0] == times[3] - times[2] == tw.FRAME_DT_US
    poses = [_load(os.path.dirname(p), os.path.basename(p))["veh_to_global"]
             for p in paths[:2]]
    assert not np.allclose(poses[0], poses[1])
