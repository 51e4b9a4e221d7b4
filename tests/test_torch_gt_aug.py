"""Port vs JAX: GT-AUG (`link_tpu_torch/data/gt_aug.py`) and the database
builder (`tools/create_data.build_gt_database`).

Host-side NumPy copies: the database files and infos, and every
`DataBaseSampler.sample_all` draw, exactly equal to the JAX package's on
the inputs of tests/test_gt_aug.py (an empty scene, a scene whose boxes
block the candidates) and on random scenes, from the same seeded stream.
"""

import os
import pickle

import numpy as np
import pytest

from link_tpu.data import gt_aug as jgt
from link_tpu_torch.data import gt_aug as tgt
from link_tpu_torch.data import nuscenes as tnus
from link_tpu_torch.tools import create_data as tcd
from test_torch_nuscenes_data import assert_same
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


class _TinyDS:
    """Two frames with one car + one pedestrian each
    (tests/test_gt_aug.py)."""

    def __len__(self):
        return 2

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        boxes = np.array([[5.0 + i, 0.0, 0.0, 2.0, 4.0, 1.5, 0, 0, 0.0],
                          [-5.0, 3.0, 0.0, 0.7, 0.7, 1.8, 0, 0, 0.0]],
                         np.float32)
        pts = []
        for b in boxes:
            p = rng.uniform(-0.3, 0.3, (50, 3)).astype(np.float32) + b[:3]
            pts.append(np.concatenate(
                [p, rng.uniform(0, 1, (50, 2)).astype(np.float32)], 1))
        noise = rng.uniform(-20, 20, (200, 5)).astype(np.float32)
        return {"points": np.concatenate(pts + [noise]),
                "gt_boxes": boxes,
                "gt_names": np.array(["car", "pedestrian"])}


def _db_files(root):
    out = {}
    for name in sorted(os.listdir(os.path.join(root, "gt_database"))):
        out[name] = np.fromfile(os.path.join(root, "gt_database", name),
                                np.float32)
    return out


@pytest.fixture(scope="module")
def databases(tmp_path_factory):
    t_root = str(tmp_path_factory.mktemp("t_db"))
    j_root = str(tmp_path_factory.mktemp("j_db"))
    return (t_root, tgt.create_gt_database(_TinyDS(), t_root),
            j_root, jgt.create_gt_database(_TinyDS(), j_root))


def test_create_gt_database_matches_jax(databases):
    t_root, t_db, j_root, j_db = databases
    assert_same(t_db, j_db, "db infos")
    assert_same(pickle.load(open(os.path.join(t_root, "dbinfos_train.pkl"),
                                 "rb")),
                pickle.load(open(os.path.join(j_root, "dbinfos_train.pkl"),
                                 "rb")), "dbinfos_train.pkl")
    assert_same(_db_files(t_root), _db_files(j_root), "gt_database")
    assert all(i["num_points_in_gt"] >= 40 for i in t_db["car"])


def test_build_gt_database_matches_jax(tmp_path):
    """`build_gt_database` on the files of `write_synthetic_infos` (10
    sweeps read through `load_sweeps`): the same database as the JAX
    tool's. Both tools draw the sweeps' order from an unseeded generator,
    so each cluster's points are compared as a set (rows sorted)."""
    from tools.create_data import build_gt_database
    roots = {}
    for who in ("port", "jax"):
        root = str(tmp_path / who)
        paths = tnus.write_synthetic_infos(root, {"train": 2}, nsweeps=10,
                                           seed=1, n_points=4000)
        if who == "port":
            db = tcd.build_gt_database(root, paths["train"], 10)
        else:
            build_gt_database(root, paths["train"], 10)
        roots[who] = root
    got = pickle.load(open(os.path.join(roots["port"], "dbinfos_train.pkl"),
                           "rb"))
    want = pickle.load(open(os.path.join(roots["jax"], "dbinfos_train.pkl"),
                            "rb"))
    assert_same(got, want, "dbinfos_train.pkl")
    assert_same(db, want, "returned")
    rows = [{k: np.unique(v.reshape(-1, 5), axis=0)
             for k, v in _db_files(roots[w]).items()} for w in roots]
    assert_same(*rows)
    assert sum(len(v) for v in got.values()) > 10


def _samplers(root, **kw):
    db = os.path.join(root, "dbinfos_train.pkl")
    return (tgt.DataBaseSampler(db, root, **kw),
            jgt.DataBaseSampler(db, root, **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_all_matches_jax(databases, seed):
    """tests/test_gt_aug.py's calls: an empty scene (everything samples),
    then a scene whose large boxes block the candidates."""
    t_root = databases[0]
    groups = dict(car=2, pedestrian=2)
    mins = dict(car=5, pedestrian=5)
    t_s, j_s = _samplers(t_root, sample_groups=groups, min_points=mins)
    assert_same(t_s.db_infos, j_s.db_infos, "filtered db")
    t_rng, j_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    empty = (np.zeros((0, 9), np.float32), np.array([], dtype="<U16"))
    got = t_s.sample_all(*empty, t_rng)
    assert_same(got, j_s.sample_all(*empty, j_rng))
    assert got is not None and len(got["gt_boxes"]) >= 2
    blocker = np.array([[5.0, 0.0, 0.0, 30.0, 30.0, 1.5, 0, 0, 0.0],
                        [-5.0, 3.0, 0.0, 30.0, 30.0, 1.8, 0, 0, 0.0]],
                       np.float32)
    names = np.array(["car", "pedestrian"])
    assert_same(t_s.sample_all(blocker, names, t_rng),
                j_s.sample_all(blocker, names, j_rng))


@pytest.mark.parametrize("seed", [3, 4])
def test_sample_all_on_random_scenes_matches_jax(databases, seed):
    """Random scenes of cars and pedestrians, the default sample groups
    and point floors, rate 1 and 0.5: the same draws, boxes and points."""
    t_root = databases[0]
    rng = np.random.default_rng(seed)
    for rate in (1.0, 0.5):
        t_s, j_s = _samplers(t_root, rate=rate)
        t_rng = np.random.default_rng(seed)
        j_rng = np.random.default_rng(seed)
        for _ in range(4):
            n = int(rng.integers(0, 6))
            boxes = np.zeros((n, 9), np.float32)
            boxes[:, :2] = rng.uniform(-8, 8, (n, 2))
            boxes[:, 3:6] = rng.uniform(0.5, 4, (n, 3))
            boxes[:, 8] = rng.uniform(-np.pi, np.pi, n)
            names = rng.choice(["car", "pedestrian"], n)
            assert_same(t_s.sample_all(boxes, names, t_rng),
                        j_s.sample_all(boxes, names, j_rng))
