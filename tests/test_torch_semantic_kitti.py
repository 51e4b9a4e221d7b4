"""The port's SemanticKITTI file reader, capacity calibration and
nuScenes-lidarseg reader against the JAX package's, and `seg_train` on a
tree of files.

A tree in the dataset's layout is written by `write_synthetic_tree`
(synthetic scans, raw uint32 labels with instance ids in the high 16 bits
and folded "moving" classes; no labels for the test split), since the
dataset is not here. Everything is exact: the readers are the same numpy
on the same files, and the training runs the same seeded steps.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

import fake_nusc
from link_tpu.data import semantic_kitti as jsk
from link_tpu_torch.data import semantic_kitti as tsk
from link_tpu_torch.data.collate import collate_scans
from link_tpu_torch.tools import calibrate_capacities as calib
from link_tpu_torch.tools import seg_train
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQS = {"00": 2, "04": 1, "08": 2, "11": 2}     # train, train, val, test
N_RAW = 3000
VOXEL = 0.4


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    paths = tsk.write_synthetic_tree(root, SEQS, N_RAW, seed=5)
    # a val scan without its label file reads as all-unlabeled
    os.remove(tsk.label_path(paths[4]))
    return root, paths


def _assert_scans_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


def test_constants_and_label_maps_equal_jax():
    assert tsk.LEARNING_MAP == jsk.LEARNING_MAP
    assert tsk.CLASS_NAMES == jsk.CLASS_NAMES
    assert (tsk.NUM_CLASSES, tsk.IGNORE_LABEL) == (jsk.NUM_CLASSES,
                                                   jsk.IGNORE_LABEL)
    assert (tsk.TRAIN_SEQS, tsk.VAL_SEQS, tsk.TEST_SEQS) == (
        jsk.TRAIN_SEQS, jsk.VAL_SEQS, jsk.TEST_SEQS)
    np.testing.assert_array_equal(tsk.build_label_map(),
                                  jsk.build_label_map())
    # the inverse map takes every class to a raw label the map takes back
    lut = tsk.build_label_map()
    inv = tsk.inverse_label_lut()
    np.testing.assert_array_equal(lut[inv], np.arange(tsk.NUM_CLASSES))
    spec = importlib.util.spec_from_file_location(
        "jax_seg_evaluate", os.path.join(REPO, "tools", "seg_evaluate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert tsk.INVERSE_LABEL_MAP == mod.INVERSE_LABEL_MAP


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_reader_equals_jax(tree, split):
    root, paths = tree
    want_ds = jsk.SemanticKITTI(root, split, VOXEL, num_points=1500)
    got_ds = tsk.SemanticKITTI(root, split, VOXEL, num_points=1500)
    assert got_ds.files == want_ds.files
    assert len(got_ds) == {"train": 3, "val": 2, "test": 2}[split]
    for i in range(len(got_ds)):
        if split == "train":      # augmentation and the cap from one seed
            got = got_ds.__getitem__(i, np.random.default_rng(3 + i))
            want = want_ds.__getitem__(i, np.random.default_rng(3 + i))
            assert len(got["coords"]) == 1500
        else:
            got, want = got_ds[i], want_ds[i]
        _assert_scans_equal(got, want)
        labels = got["point_labels"]
        if split == "test" or got["file_name"] == paths[4]:
            assert not labels.any()
        else:
            # the instance bits are masked off and every class is present
            assert labels.max() < 20 and len(np.unique(labels)) > 10
    if split == "val":
        strided = tsk.SemanticKITTI(root, split, VOXEL, sample_stride=2)
        assert strided.files == jsk.SemanticKITTI(
            root, split, VOXEL, sample_stride=2).files == [paths[3]]


def test_reader_folds_moving_classes_and_masks_instances(tree):
    root, paths = tree
    raw = np.fromfile(tsk.label_path(paths[3]), np.uint32)
    assert (raw >> 16).any() and ((raw & 0xFFFF) == 252).any()
    _, labels = tsk.SemanticKITTI(root, "val", VOXEL).raw(0)
    np.testing.assert_array_equal(labels,
                                  jsk.build_label_map()[raw & 0xFFFF])
    assert (labels[(raw & 0xFFFF) == 252] == 1).all()


def test_missing_root_raises_and_names_the_path(tmp_path):
    missing = str(tmp_path / "nowhere")
    with pytest.raises(FileNotFoundError, match="nowhere"):
        tsk.dataset_root(missing)
    with pytest.raises(FileNotFoundError, match="nowhere"):
        seg_train.main([os.path.join(REPO, "configs", "semantic_kitti",
                                     "minkunet", "default.yaml"),
                        "--device", "cpu", f"dataset.root={missing}"])
    with pytest.raises(FileNotFoundError, match="nowhere"):
        calib.main(["--root", missing])


def _jax_level_counts():
    spec = importlib.util.spec_from_file_location(
        "jax_calibrate", os.path.join(REPO, "tools",
                                      "calibrate_capacities.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.level_counts


def test_calibrate_capacities_counts_equal_jax(tree, capsys):
    root, _ = tree
    level_counts = _jax_level_counts()
    ds = tsk.SemanticKITTI(root, "val", VOXEL)
    counts = calib.batch_counts(ds, 8, 2)
    b = collate_scans([ds[0], ds[1]], 10 ** 5)
    want = level_counts(b["coords"][:int(b["nnz"])])
    assert counts.tolist() == [want]
    assert calib.suggest(counts) == [
        int(np.ceil(c * 1.06 / 256) * 256) for c in want]
    assert calib.main(["--root", root, "--split", "val", "--batch", "2",
                       "--voxel-size", str(VOXEL)]) == 0
    printed = capsys.readouterr().out
    assert f"capacities: {calib.suggest(counts)}" in printed
    # the synthetic source: each batch as the JAX tool counts it
    syn = tsk.SyntheticSemanticKITTI(length=4, voxel_size=1.6, split="val")
    got = calib.batch_counts(syn, 4, 2)
    for k in range(2):
        b = collate_scans([syn[2 * k], syn[2 * k + 1]], 10 ** 5)
        assert got[k].tolist() == level_counts(b["coords"][:int(b["nnz"])])
    assert calib.main(["--synthetic", "--scans", "2", "--batch", "2",
                       "--voxel-size", "1.6"]) == 0
    assert "1 batches of 2 scans" in capsys.readouterr().out


def test_nuscenes_lidarseg_equals_jax(tmp_path, monkeypatch):
    from link_tpu.data import nuscenes_lidarseg as jns
    from link_tpu_torch.data import nuscenes_lidarseg as tns
    root = str(tmp_path / "nusc")
    fake_nusc.install(monkeypatch, root)
    import nuscenes
    nuscenes.NuScenes("v1.0-trainval", root)     # writes the bins
    assert tns.LEARNING_MAP == jns.LEARNING_MAP
    assert (tns.CLASS_NAMES, tns.NUM_CLASSES, tns.IGNORE_LABEL) == (
        jns.CLASS_NAMES, jns.NUM_CLASSES, jns.IGNORE_LABEL)
    np.testing.assert_array_equal(tns.build_label_map(),
                                  jns.build_label_map())
    for split, kw in (("train", {}), ("val", {}),
                      ("test", {"version": "v1.0-trainval"})):
        got_ds = tns.NuScenesLidarSeg(root, split, num_points=1024, **kw)
        want_ds = jns.NuScenesLidarSeg(root, split, num_points=1024, **kw)
        assert got_ds.tokens == want_ds.tokens and len(got_ds) == 2
        for i in range(len(got_ds)):
            _assert_scans_equal(
                got_ds.__getitem__(i, np.random.default_rng(i)),
                want_ds.__getitem__(i, np.random.default_rng(i)))
        if split == "test":
            assert not got_ds[0]["labels"].any()
    monkeypatch.setitem(__import__("sys").modules, "nuscenes", None)
    with pytest.raises(ImportError, match="nuscenes-devkit"):
        tns.NuScenesLidarSeg(root)


# the val scans (~2,300 voxels at 0.4 m, uncapped) fit every level
TINY = ["model.capacities=[2560,1792,1024,576,320]", "model.cr=0.125",
        "dataset.num_points=1500", f"dataset.voxel_size={VOXEL}",
        "batch_size=1", "num_epochs=2"]


def _train(root, run_dir, *args):
    config = os.path.join(REPO, "configs", "semantic_kitti", "minkunet",
                          "default.yaml")
    assert seg_train.main([config, "--device", "cpu", "--run-dir", run_dir,
                           *args, f"dataset.root={root}", *TINY]) == 0
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return {r["epoch"]: r for r in map(json.loads, f) if "epoch" in r}


def test_seg_train_on_files_resumes_to_the_same_run(tree, tmp_path,
                                                    capsys):
    """Two epochs on the tree's 3 train scans (val: its 2 scans) straight,
    against one epoch, a stop and `--resume auto`: the same losses and
    mIoU."""
    root, _ = tree
    straight = _train(root, str(tmp_path / "a"))
    assert "SemanticKITTI at" in capsys.readouterr().out
    b = str(tmp_path / "b")
    first = _train(root, b, "--stop-after-epoch", "1")
    resumed = _train(root, b, "--resume", "auto")
    assert "resumed" in capsys.readouterr().out
    assert sorted(first) == [1]
    assert sorted(straight) == sorted(resumed) == [1, 2]
    for epoch in (1, 2):
        for k in ("loss/train", "iou/val"):
            assert resumed[epoch][k] == straight[epoch][k], (epoch, k)
    assert np.isfinite(straight[2]["loss/train"])
    assert os.path.exists(os.path.join(b, "epoch_2.pt"))
