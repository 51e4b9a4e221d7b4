"""Port vs JAX: the nuScenes detection data (`link_tpu_torch/data/
nuscenes.py`, `tools/create_data.py`).

Host-side NumPy copies, so every comparison is exact (the same arrays,
the same random stream per seed): `load_sweeps`, `cbgs_resample`,
`NuScenesDataset` in train mode (voxels, boxes, classes, CenterNet
targets; with and without GT-AUG) and in val mode (the GT passthrough,
`tt_rotation`, `double_flip`), `make_double_flip_variants` and
`SyntheticNuScenes`' TTA options, on the `tests/fake_nusc.py` world and on
the files of the port's `write_synthetic_infos`; the port's
`nuscenes_data_prep` writes the same info pkls as `tools/create_data.py`.
"""

import os
import pickle
import sys

import numpy as np
import pytest
from scipy.spatial import cKDTree

import fake_nusc
from link_tpu.data import gt_aug as jgt
from link_tpu.data import nuscenes as jnus
from link_tpu_torch.data import gt_aug as tgt
from link_tpu_torch.data import nuscenes as tnus
from link_tpu_torch.tools import create_data as tcd
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the tests' tiny detection grid (tests/test_det_train_step.py)
TINY = dict(pc_range=(-12, -12, -2, 12, 12, 2), voxel_size=(0.5, 0.5, 0.1),
            max_voxels=(4000, 4000))
NSWEEPS = 3


@pytest.fixture(scope="module")
def fake_world(tmp_path_factory):
    """The fake_nusc world's info pkls by the JAX tool, then by the port's
    (each loaded back), its GT database by the JAX tool."""
    root = str(tmp_path_factory.mktemp("nusc"))
    saved = {m: sys.modules.get(m) for m in ("nuscenes", "nuscenes.utils")}

    class _MP:
        def setitem(self, d, k, v):
            d[k] = v

    fake_nusc.install(_MP(), root)
    try:
        from tools.create_data import build_gt_database, nuscenes_data_prep
        want = nuscenes_data_prep(root, version="v1.0-mini", nsweeps=NSWEEPS)
        names = [f"infos_{s}_{NSWEEPS}sweeps_withvelo_filter_True.pkl"
                 for s in ("train", "val")]
        want_files = [pickle.load(open(os.path.join(root, n), "rb"))
                      for n in names]
        got = tcd.nuscenes_data_prep(root, version="v1.0-mini",
                                     nsweeps=NSWEEPS)
        got_files = [pickle.load(open(os.path.join(root, n), "rb"))
                     for n in names]
        build_gt_database(root, os.path.join(root, names[0]), NSWEEPS)
    finally:
        for m, v in saved.items():
            if v is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = v
    return {"root": root, "want": want, "got": got, "want_files": want_files,
            "got_files": got_files,
            "train": os.path.join(root, names[0]),
            "val": os.path.join(root, names[1]),
            "db": os.path.join(root, "dbinfos_train.pkl")}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Files of the port's write_synthetic_infos at a tiny point count."""
    root = str(tmp_path_factory.mktemp("synthetic_nusc"))
    paths = tnus.write_synthetic_infos(root, {"train": 5, "val": 2},
                                       nsweeps=NSWEEPS, seed=3,
                                       n_points=3000)
    return root, paths


def assert_same(got, want, where="sample"):
    """Exactly equal nested dicts / lists / arrays / scalars (a NaN equal
    to a NaN)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got), where
    else:
        assert got == want, where


def test_nuscenes_data_prep_writes_the_jax_tools_infos(fake_world):
    assert_same(fake_world["got"], fake_world["want"], "returned")
    assert_same(fake_world["got_files"], fake_world["want_files"], "pkl")


def test_transform_matrix_matches_jax():
    from tools.create_data import transform_matrix
    rng = np.random.default_rng(0)
    for _ in range(4):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.normal(size=3)
        for inv in (False, True):
            np.testing.assert_array_equal(tcd.transform_matrix(t, q, inv),
                                          transform_matrix(t, q, inv))


@pytest.mark.parametrize("seed", [0, 5])
def test_load_sweeps_matches_jax(fake_world, written, seed):
    infos = (fake_world["want_files"][0] + fake_world["want_files"][1]
             + pickle.load(open(written[1]["train"], "rb")))
    for info in infos:
        for n in (1, 2, NSWEEPS):
            got = tnus.load_sweeps(info, n, np.random.default_rng(seed))
            want = jnus.load_sweeps(info, n, np.random.default_rng(seed))
            assert_same(got, want)


def test_write_synthetic_infos_files(written):
    """The schema of nuscenes_data_prep; the first keyframe of a scene
    repeats itself with transform None, the others have nsweeps - 1 real
    sweeps whose transforms bring the frame's points back."""
    root, paths = written
    infos = pickle.load(open(paths["train"], "rb"))
    assert len(infos) == 5
    for key in ("lidar_path", "token", "sweeps", "ref_from_car",
                "car_from_global", "timestamp", "gt_boxes", "gt_names",
                "gt_boxes_velocity", "gt_attributes", "gt_num_pts"):
        assert key in infos[0], key
    first = infos[0]["sweeps"]
    assert [s["transform_matrix"] for s in first] == [None] * (NSWEEPS - 1)
    assert all(s["lidar_path"] == infos[0]["lidar_path"] for s in first)
    src = tnus.SyntheticNuScenes(seed=3, n_points=3000)
    for i in (1, 2, 3):
        tms = [s["transform_matrix"] for s in infos[i]["sweeps"]]
        assert all(np.abs(tm - np.eye(4)).max() > 0.1 for tm in tms)
        pts = tnus.load_sweeps(infos[i], NSWEEPS, np.random.default_rng(0))
        want = src.points(i)
        # each point back in the keyframe's frame (float32 round trips,
        # 1e-3 m), once, with its intensity; the ego-return filter of the
        # sweeps drops the few within 1 m in x and y
        d, j = cKDTree(want[:, :3]).query(pts[:, :3])
        assert d.max() < 1e-3 and len(np.unique(j)) == len(pts)
        assert len(pts) >= 0.99 * len(want)
        np.testing.assert_array_equal(pts[:, 3], want[j, 3])
    assert infos[4]["sweeps"][0]["transform_matrix"] is None   # scene 2
    for info in infos:
        assert (info["gt_num_pts"] > 0).all()
        assert info["gt_boxes"].shape == (len(info["gt_names"]), 9)
    assert any("ignore" in info["gt_names"] for info in infos)


@pytest.mark.parametrize("seed", [0, 1])
def test_cbgs_resample_matches_jax(written, seed):
    infos = pickle.load(open(written[1]["train"], "rb"))
    names = tnus.NUSC_CLASSES
    got = tnus.cbgs_resample(infos, names, np.random.default_rng(seed))
    want = jnus.cbgs_resample(infos, names, np.random.default_rng(seed))
    assert len(got) > len(infos)
    assert [i["token"] for i in got] == [i["token"] for i in want]


def _datasets(path, **kw):
    return (tnus.NuScenesDataset(path, nsweeps=NSWEEPS, **TINY, **kw),
            jnus.NuScenesDataset(path, nsweeps=NSWEEPS, **TINY, **kw))


def test_train_dataset_matches_jax(fake_world):
    """Train mode on the fake world's infos, CBGS off (two frames of two
    classes): voxels, coords, points per voxel, boxes, classes and every
    target equal, frame after frame from one seeded stream."""
    got_ds, want_ds = _datasets(fake_world["train"], mode="train",
                                use_cbgs=False, seed=4)
    for _ in range(2):
        for i in range(len(want_ds)):
            got = got_ds[i]
            assert_same(got, want_ds[i])
            assert len(got["gt_boxes"]) >= 1


def test_train_dataset_with_gt_aug_matches_jax(written):
    """Train mode with GT-AUG on the written files: the JAX tool's
    database of the train infos, sampled through each package's
    `DataBaseSampler`; the same samples, and pasted boxes in some."""
    from tools.create_data import build_gt_database
    root, paths = written
    build_gt_database(root, paths["train"], NSWEEPS)
    db = os.path.join(root, "dbinfos_train.pkl")
    kw = dict(mode="train", use_cbgs=False, seed=8)
    got_ds = tnus.NuScenesDataset(paths["train"], nsweeps=NSWEEPS,
                                  db_sampler=tgt.DataBaseSampler(db, root),
                                  **TINY, **kw)
    want_ds = jnus.NuScenesDataset(paths["train"], nsweeps=NSWEEPS,
                                   db_sampler=jgt.DataBaseSampler(db, root),
                                   **TINY, **kw)
    pasted = 0
    for i in range(len(want_ds)):
        got = got_ds[i]
        assert_same(got, want_ds[i])
        names = np.asarray(got_ds.infos[i]["gt_names"])
        pasted += len(got["gt_boxes"]) - int(np.isin(
            names, tnus.NUSC_CLASSES).sum())
    assert pasted > 0


def test_train_dataset_with_cbgs_matches_jax(written):
    got_ds, want_ds = _datasets(written[1]["train"], mode="train", seed=2)
    assert len(got_ds) == len(want_ds) > 5
    for i in range(3):
        assert_same(got_ds[i], want_ds[i])


@pytest.mark.parametrize("tta", [dict(), dict(tt_rotation=0.3),
                                 dict(double_flip=True),
                                 dict(tt_rotation=-0.2, double_flip=True)])
def test_val_dataset_matches_jax(fake_world, written, tta):
    """Val mode: the unaugmented GT with attributes and point counts, the
    input rotation and the three flipped voxelizations."""
    for path in (fake_world["val"], written[1]["val"]):
        got_ds, want_ds = _datasets(path, mode="val", **tta)
        for i in range(len(want_ds)):
            got, want = got_ds[i], want_ds[i]
            assert_same(got, want)
            assert "gt_attributes" in got and "gt_num_pts" in got
            assert ("flip_variants" in got) == bool(tta.get("double_flip"))


def test_double_flip_variants_match_jax():
    rng = np.random.default_rng(6)
    pts = rng.uniform(-11, 11, (2000, 5)).astype(np.float32)
    args = (pts, TINY["voxel_size"], TINY["pc_range"], 10, 3000)
    got = tnus.make_double_flip_variants(*args)
    assert_same(got, jnus.make_double_flip_variants(*args))
    assert len(got) == 3
    flipped = [v["coords_zyx"] for v in got]
    assert not np.array_equal(flipped[0], flipped[1])


@pytest.mark.parametrize("mode", ["train", "val"])
def test_synthetic_tta_options_match_jax(mode):
    kw = dict(length=2, n_points=3000, pc_range=TINY["pc_range"],
              voxel_size=TINY["voxel_size"], max_voxels=3000,
              tt_rotation=0.25, double_flip=True)
    got = tnus.SyntheticNuScenes(mode=mode, **kw)[1]
    want = jnus.SyntheticNuScenes(mode=mode, **kw)[1]
    if mode == "val":   # the JAX source draws GT in val mode too
        want = {k: v for k, v in want.items() if k in got}
    assert_same(got, want)
