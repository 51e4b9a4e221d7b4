"""`link_tpu_torch.tools.det_test`, `det_train` on files and `tta_fuse` on
the CPU at the tests' tiny size.

nuScenes-format files of `data/nuscenes.write_synthetic_infos` (3,000
points a frame, 3 sweeps) over the 48 x 48 x 40 grid of
tests/test_det_train_step.py (voxels 0.5 x 0.5 x 0.1 m, capacity 4,096 a
frame), by patching the tools' `NuScenesDataset`, `GRID`, `CAPACITY` and
`TEST_CFG`. det_test with host and with device NMS keeps the same boxes,
and its mAP / NDS are the JAX package's `evaluate_nuscenes` on its own
`--out` records (exactly); `--double-flip` runs the four flips as one
batch whose maps are the four batch-1 forwards' (float32, 1e-5);
`--tt-rotation` rotates its predictions back by the JAX package's
`rotate_predictions_back` (exactly). det_train trains on the files with
GT-AUG and drops it from `--no-aug-from`, also across a resume;
`tta_fuse --fuse-only` writes the JAX tool's `fuse_files` records.
"""

import functools
import json
import os
import pickle

import numpy as np
import pytest
import torch

from link_tpu.eval import nuscenes_eval as JNE
from link_tpu.eval.tta_fusion import rotate_predictions_back
from link_tpu_torch.data import det_pipeline as dp
from link_tpu_torch.data import nuscenes as tnus
from link_tpu_torch.data.gt_aug import DataBaseSampler
from link_tpu_torch.inference import masked_rows
from link_tpu_torch.models.voxelnet import VoxelNet
from link_tpu_torch.tools import create_data, det_test, det_train, tta_fuse
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY_DS = dict(pc_range=(-12, -12, -2, 12, 12, 2),
               voxel_size=(0.5, 0.5, 0.1), max_voxels=(4000, 4000))
TINY_CFG = dict(pc_range=[-12, -12], voxel_size=[0.5, 0.5],
                post_center_limit_range=[-15, -15, -10, 15, 15, 10])
GRID = (48, 48, 40)
NSWEEPS = 3


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    paths = tnus.write_synthetic_infos(root, {"train": 2, "val": 2},
                                       nsweeps=NSWEEPS, seed=0,
                                       n_points=3000)
    return root, paths


@pytest.fixture
def tiny(monkeypatch):
    ds = functools.partial(tnus.NuScenesDataset, nsweeps=NSWEEPS, **TINY_DS)
    monkeypatch.setattr(det_test, "GRID", GRID)
    monkeypatch.setattr(det_test, "CAPACITY", 4096)
    monkeypatch.setattr(det_test, "TEST_CFG",
                        dict(det_test.TEST_CFG, **TINY_CFG))
    monkeypatch.setattr(det_test, "NuScenesDataset", ds)
    # two frames a step at 2 a step: one step an epoch without CBGS
    monkeypatch.setattr(det_train, "NuScenesDataset",
                        functools.partial(ds, use_cbgs=False))


def _test(tree, *extra):
    root, paths = tree
    return det_test.evaluate(det_test.parse_args(
        ["--info-path", paths["val"], "--root-path", root, "--device",
         "cpu", *extra]))


def _records(path):
    with open(path) as f:
        return [{k: np.asarray(v) if isinstance(v, list) else v
                 for k, v in r.items()} for r in json.load(f)]


def _jax_metrics(records):
    gt_c, pr_c, sc_c, at_c = JNE.group_by_class(records)
    return JNE.evaluate_nuscenes(gt_c, pr_c, sc_c, attrs_by_class=at_c)


def test_det_test_host_and_device_nms(tree, tiny, tmp_path):
    host = _test(tree, "--out", str(tmp_path / "host.json"), "--save-vis",
                 str(tmp_path / "vis.pkl"))
    dev = _test(tree, "--device-nms", "--out", str(tmp_path / "dev.json"))
    assert len(host["samples"]) == len(dev["samples"]) == 2
    kept = 0
    for a, b in zip(host["samples"], dev["samples"]):
        for k in ("pred_boxes", "pred_scores", "pred_labels"):
            np.testing.assert_array_equal(a[k], b[k])
        assert np.isfinite(a["pred_boxes"]).all()
        assert len(a["gt_boxes"]) == len(a["gt_classes"]) > 0
        kept += len(a["pred_scores"])
    assert kept > 0
    with open(tmp_path / "vis.pkl", "rb") as f:
        vis = pickle.load(f)
    assert [len(v["detections"]["scores"]) for v in vis] == [
        len(s["pred_scores"]) for s in host["samples"]]
    assert all(v["points"].shape[1] == 3 and len(v["points"]) for v in vis)
    for r, name in ((host, "host"), (dev, "dev")):
        recs = _records(tmp_path / f"{name}.json")
        assert [s["token"] for s in recs] == [s["token"]
                                              for s in r["samples"]]
        want = _jax_metrics(recs)
        assert r["metrics"]["mean_ap"] == want["mean_ap"]
        assert r["metrics"]["nds"] == want["nds"]
        assert np.isfinite([want["mean_ap"], want["nds"]]).all()


def test_det_test_double_flip(tree, tiny):
    """The tool's batch of 4 flips; its model's maps against four batch-1
    forwards of the same inputs with the same weights."""
    r = _test(tree, "--double-flip")
    assert all(np.isfinite(s["pred_boxes"]).all() for s in r["samples"])
    args = det_test.parse_args(["--info-path", tree[1]["val"],
                                "--double-flip", "--device", "cpu"])
    run = det_test.DetTest(args, "cpu")
    assert run.cap == 4 * 4096 and run.n_batch == 4
    one = VoxelNet(batch_size=1, grid_shape=GRID,
                   capacities=(4096, 2048, 1024, 512), device="cpu")
    one.load_state_dict(run.model.state_dict())
    one.eval()
    s = det_test.make_dataset(args)[1]
    keys = ("voxels", "coords_zyx", "num_points")
    group = [{k: s[k] for k in keys}] + s["flip_variants"]
    with torch.no_grad():
        four = run.model(*dp.det_inputs(run.batch(s), "cpu"))
        for g, single in enumerate(group):
            p1 = one(*dp.det_inputs(dp.collate_det([single], 4096), "cpu"))
            for a, b in zip(four, p1):
                for k in a:
                    torch.testing.assert_close(a[k][g:g + 1], b[k],
                                               rtol=1e-5, atol=1e-5)
    rows = masked_rows(run.forward(run.batch(s)))
    got = r["samples"][1]
    for want, key in zip(run.detections(rows),
                         ("pred_boxes", "pred_scores", "pred_labels")):
        np.testing.assert_array_equal(got[key], want)


def test_det_test_rotates_predictions_back(tree, tiny):
    deg = 12.5
    r = _test(tree, "--tt-rotation", str(deg))
    args = det_test.parse_args(["--info-path", tree[1]["val"],
                                "--device", "cpu"])
    run = det_test.DetTest(args, "cpu")
    ds = tnus.NuScenesDataset(tree[1]["val"], nsweeps=NSWEEPS, mode="val",
                              tt_rotation=float(np.deg2rad(deg)), **TINY_DS)
    kept = 0
    for i, got in enumerate(r["samples"]):
        pb, ps, pl = run.detections(masked_rows(run.forward(
            run.batch(ds[i]))))
        np.testing.assert_array_equal(
            got["pred_boxes"], rotate_predictions_back(pb, np.deg2rad(deg)))
        np.testing.assert_array_equal(got["pred_scores"], ps)
        kept += len(ps)
    assert kept > 0


@pytest.mark.parametrize("flags", [["--two-stage"],
                                   ["--two-stage-checkpoint", "r.pkl"],
                                   ["--dcn-head"],
                                   ["--dense-from-level", "2"],
                                   "dcn_config"])
def test_det_test_refuses_the_unported_options(tmp_path, flags):
    if flags == "dcn_config":
        cfg = tmp_path / "dcn.py"
        cfg.write_text("model = dict(bbox_head=dict(dcn_head=True))\n")
        flags = ["--config", str(cfg)]
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 6"):
        det_test.main(["--synthetic", "--device", "cpu", *flags])


def test_the_tools_raise_on_missing_files(tmp_path, tree):
    missing = str(tmp_path / "no_infos.pkl")
    with pytest.raises(FileNotFoundError, match="no_infos.pkl"):
        det_test.main(["--info-path", missing, "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="no_infos.pkl"):
        det_train.main(["--info-path", missing, "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="no_db.pkl"):
        det_train.main(["--info-path", tree[1]["train"], "--db-info-path",
                        str(tmp_path / "no_db.pkl"), "--device", "cpu"])


def test_det_train_on_files_fades_gt_aug_across_a_resume(tree, tiny, tmp_path,
                                                         monkeypatch):
    """2 epochs on the files with GT-AUG: epoch 1 samples from the
    database; epoch 2, resumed with --no-aug-from 2, does not. det_test
    reads the checkpoint."""
    root, paths = tree
    create_data.build_gt_database(root, paths["train"], NSWEEPS)
    calls = []
    real = DataBaseSampler.sample_all

    def counted(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    monkeypatch.setattr(DataBaseSampler, "sample_all", counted)
    run_dir = tmp_path / "run"
    args = ["--info-path", paths["train"], "--root-path", root,
            "--db-info-path", os.path.join(root, "dbinfos_train.pkl"),
            "--epochs", "2", "--run-dir", str(run_dir), "--device", "cpu",
            "--voxel-capacity", "4096", "--grid", *map(str, GRID)]
    assert det_train.main(args + ["--stop-after-epoch", "1"]) == 0
    first = len(calls)
    assert first == 2                       # both frames of epoch 1
    assert det_train.main(args + ["--resume", "auto", "--no-aug-from",
                                  "2"]) == 0
    assert len(calls) == first
    logs = [json.loads(line) for line in
            open(run_dir / "metrics.jsonl").read().splitlines()]
    assert [(r["epoch"], r["step"], r["gt_aug"]) for r in logs] == [
        (1, 1, True), (2, 2, False)]
    assert all(np.isfinite(r["loss/train"]) for r in logs)
    r = _test(tree, "--checkpoint", str(run_dir / "latest.pt"))
    assert np.isfinite([r["metrics"]["mean_ap"], r["metrics"]["nds"]]).all()


def test_tta_fuse_fuse_only_matches_jax(tree, tiny, tmp_path):
    """`tta_fuse --fuse-only` on two rotations' det_test JSONs: the JAX
    tool's fused records."""
    from tools.tta_fuse import fuse_files
    paths = []
    for deg in ("0", "12.5"):
        paths.append(str(tmp_path / f"rot_{deg}.json"))
        _test(tree, "--tt-rotation", deg, "--out", paths[-1])
    out = tmp_path / "tta"
    assert tta_fuse.main(["--out-dir", str(out), "--fuse-only",
                          *paths]) == 0
    got = json.load(open(out / "fused.json"))
    want = [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in s.items()} for s in fuse_files(paths)]
    assert got == want
    assert sum(len(s["pred_scores"]) for s in got) > 0
