"""The port's `seg_evaluate` entry point on the CPU at a tiny size: it
restores a saved port checkpoint of each seg family, and its point-level
mIoU, its capacity-audit warning and its `.label` files equal what the
model, `seg_eval_step` and the scans' inverse maps give directly. The
capacity audit equals the JAX package's. On a SemanticKITTI tree of
written files: rotation voting (`--tta`), each vote's point probabilities
within 1e-5 of the JAX MinkUNet's forward of the same rotated scan on the
translated weights (float32, ~20 layers in another order); the test split
with `--save-labels`; a missing root raises. All other comparisons are
exact.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from link_tpu.data import collate as jcollate
from link_tpu.models.minkunet import MinkUNet as JMinkUNet
from link_tpu.sparse.tensor import make_sparse_tensor as j_make
from link_tpu.utils.torch_import import translate_minkunet
from link_tpu_torch.data import collate as tcollate
from link_tpu_torch.data import semantic_kitti as tsk
from link_tpu_torch.data.semantic_kitti import SyntheticSemanticKITTI
from link_tpu_torch.models import builder
from link_tpu_torch.tools import seg_evaluate
from link_tpu_torch.train import trainer as T
from link_tpu_torch.train.checkpoint import save_checkpoint
from link_tpu_torch.train.metrics import MeanIoU, iou_counters
from link_tpu_torch.utils.config import load_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 1.6 m voxels: ~5,500 per synthetic val scan; the capacities x 1.6 hold
# levels 0-3 and overflow level 4 (44 voxels in 32 rows)
TINY = ["model.capacities=[3500,1100,320,100,20]", "model.cr=0.125",
        "dataset.voxel_size=1.6"]


def _config(family):
    return os.path.join(REPO, "configs", "semantic_kitti", family,
                        "default.yaml")


@pytest.mark.parametrize("family",
                         ["linkunet", "linkencoder", "minkunet", "spvcnn"])
def test_seg_evaluate_restores_and_scores_points(family, tmp_path, capsys):
    cfg = load_config(_config(family), TINY)
    caps = tuple(int(c * 1.6) for c in cfg.model.capacities)
    model = builder.make_model(cfg, capacities=caps, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    state = T.TrainState(model, builder.make_optimizer(
        cfg, model.parameters(), 0.1), step=3)
    ckpt = save_checkpoint(str(tmp_path / "run"), state, epoch=1)
    labels_dir = str(tmp_path / "labels")

    out = seg_evaluate.evaluate(seg_evaluate.parse_args(
        [_config(family), ckpt, "--synthetic", "--limit", "2",
         "--save-labels", labels_dir, "--device", "cpu"] + TINY))
    printed = capsys.readouterr().out
    assert f"restored {ckpt} (step 3)" in printed
    assert "WARNING: 2/2 scans overflowed" in printed
    assert f"point-level val mIoU: {out['miou'] * 100:.2f}" in printed

    # the same two scans straight through the saved model
    ds = SyntheticSemanticKITTI(length=8, voxel_size=1.6, num_points=10 ** 9,
                                split="val")
    miou = MeanIoU(cfg.data.num_classes, cfg.data.ignore_label)
    lut = tsk.inverse_label_lut()
    overflow = np.zeros(5, np.int64)
    for i in range(2):
        scan = ds[i]
        b = tcollate.collate_scans([scan], caps[0])
        overflow += tcollate.audit_capacities(b["coords"][:int(b["nnz"])],
                                              caps)
        preds, _ = T.seg_eval_step(model, b, 20, 0)
        pp = preds.numpy()[:int(b["nnz"])][scan["inverse_map"]]
        labels = scan["point_labels"]
        miou.update(iou_counters(torch.from_numpy(pp),
                                 torch.from_numpy(labels),
                                 torch.ones(len(labels), dtype=torch.bool),
                                 20, 0))
        written = np.fromfile(os.path.join(labels_dir, f"{i:06d}.label"),
                              np.uint32)
        np.testing.assert_array_equal(written, lut[pp])
    assert out["miou"] == miou.compute() and out["scans"] == 2
    assert out["overflow_scans"] == 2 and out["overflow"] == overflow.tolist()
    assert overflow[:4].tolist() == [0] * 4 and overflow[4] > 0
    np.testing.assert_array_equal(out["per_class"], miou.per_class())


def test_audit_capacities_matches_jax():
    scan = SyntheticSemanticKITTI(length=1, voxel_size=0.8,
                                  num_points=10 ** 9, split="val")[0]
    b = tcollate.collate_scans([scan], 16000)
    coords = b["coords"][:int(b["nnz"])]
    for caps in ((16000, 4000, 1000, 300, 100), (13070, 4950, 1617, 468, 146)):
        assert (tcollate.level_unique_counts(coords, 5)
                == jcollate.level_unique_counts(coords, 5))
        got = tcollate.audit_capacities(coords, caps)
        assert got == jcollate.audit_capacities(coords, caps)
    assert any(tcollate.audit_capacities(coords, (16000, 4000, 1000, 300,
                                                  100)))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A SemanticKITTI tree of synthetic scans: 2 val scans (sequence 08)
    and 2 test scans (sequence 11, no labels)."""
    root = str(tmp_path_factory.mktemp("kitti"))
    tsk.write_synthetic_tree(root, {"08": 2, "11": 2}, n_raw_points=20000,
                             seed=2)
    return root


@pytest.fixture(scope="module")
def minkunet(tmp_path_factory):
    """(config overrides, capacities, port model, checkpoint) of a seeded
    MinkUNet at the tiny size."""
    cfg = load_config(_config("minkunet"), TINY)
    caps = tuple(int(c * 1.6) for c in cfg.model.capacities)
    model = builder.make_model(cfg, capacities=caps, device="cpu",
                               generator=torch.Generator().manual_seed(4))
    ckpt = save_checkpoint(str(tmp_path_factory.mktemp("run")), T.TrainState(
        model, builder.make_optimizer(cfg, model.parameters(), 0.1)), 1)
    return caps, model.eval(), ckpt


@pytest.fixture(scope="module")
def jax_probs(minkunet):
    """scan -> JAX MinkUNet's point softmax of it, on the port's weights
    (translated), jitted once."""
    caps, model, _ = minkunet
    jmodel = JMinkUNet(num_classes=20, cr=0.125, capacities=caps)
    variables = translate_minkunet({k: v.detach().clone().numpy()
                                    for k, v in model.state_dict().items()})
    fwd = jax.jit(lambda f, c, n: jax.nn.softmax(jmodel.apply(
        variables, j_make(f, c, nnz=n, base_sorted=True), False), -1))

    def probs(scan):
        b = tcollate.collate_scans([scan], caps[0])
        p = np.asarray(fwd(b["feats"], b["coords"], b["nnz"]))
        return p[:int(b["nnz"])][scan["inverse_map"]]

    return probs


def _args(root, ckpt, *extra):
    return seg_evaluate.parse_args(
        [_config("minkunet"), ckpt, "--device", "cpu", *extra,
         *TINY, f"dataset.root={root}"])


def test_seg_evaluate_tta_votes_match_jax(tree, minkunet, jax_probs,
                                          tmp_path, capsys):
    """`--tta 4 --split val`: each vote (a rotation of the raw scan,
    voxelized anew) has the JAX forward's point probabilities within 1e-5;
    the saved labels are the argmax of the votes' sum, and the mIoU is
    scored on them."""
    caps, model, ckpt = minkunet
    out = seg_evaluate.evaluate(_args(tree, ckpt, "--tta", "4",
                                      "--save-labels", str(tmp_path)))
    assert f"point-level val mIoU: {out['miou'] * 100:.2f}" in \
        capsys.readouterr().out
    ds = tsk.SemanticKITTI(tree, "val", 1.6, num_points=10 ** 9)
    lut = tsk.inverse_label_lut()
    miou = MeanIoU(20, 0)
    for i, path in enumerate(out["label_files"]):
        assert path == os.path.join(str(tmp_path), "08", "predictions",
                                    f"{i:06d}.label")
        points, labels = ds.raw(i)
        scans = list(seg_evaluate.tta_scans(points, labels, 1.6, 4))
        # each vote sees the scan turned: other voxel rows
        assert not any(np.array_equal(scans[0]["feats"], s["feats"])
                       for s in scans[1:])
        votes = 0
        for v, scan in enumerate(scans):
            got = seg_evaluate.point_probs(model, scan, caps).numpy()
            want = jax_probs(scan)
            assert np.abs(got - want).max() < 1e-5, (i, v)
            votes = votes + got
        preds = votes.argmax(-1)
        np.testing.assert_array_equal(np.fromfile(path, np.uint32),
                                      lut[preds])
        miou.update(iou_counters(torch.from_numpy(preds),
                                 torch.from_numpy(labels),
                                 torch.ones(len(labels), dtype=torch.bool),
                                 20, 0))
    assert len(out["label_files"]) == 2 and out["miou"] == miou.compute()


def test_seg_evaluate_tta_1_is_the_plain_forward(tree, minkunet):
    """One vote (the scan unturned) predicts what the plain path does."""
    _, _, ckpt = minkunet
    got = seg_evaluate.evaluate(_args(tree, ckpt, "--tta", "1"))
    want = seg_evaluate.evaluate(_args(tree, ckpt))
    assert got["scans"] == want["scans"] == 2
    assert got["miou"] == want["miou"]
    np.testing.assert_array_equal(got["per_class"], want["per_class"])


def test_seg_evaluate_test_split_saves_labels(tree, minkunet, tmp_path,
                                              capsys):
    """`--split test --save-labels`: no labels read and no mIoU; one uint32
    per point in `<seq>/predictions/<n>.label`, the class's raw label."""
    caps, model, ckpt = minkunet
    out = seg_evaluate.evaluate(_args(tree, ckpt, "--split", "test",
                                      "--save-labels", str(tmp_path)))
    assert "mIoU" not in capsys.readouterr().out
    assert out["miou"] is None and out["scans"] == 2
    ds = tsk.SemanticKITTI(tree, "test", 1.6, num_points=10 ** 9)
    lut = tsk.inverse_label_lut()
    for i, path in enumerate(out["label_files"]):
        assert path == os.path.join(str(tmp_path), "11", "predictions",
                                    f"{i:06d}.label")
        written = np.fromfile(path, np.uint32)
        scan = ds[i]
        assert written.shape == scan["inverse_map"].shape
        assert not scan["point_labels"].any()
        b = tcollate.collate_scans([scan], caps[0])
        preds, _ = T.seg_eval_step(model, b, 20, 0)
        pp = preds.numpy()[:int(b["nnz"])][scan["inverse_map"]]
        np.testing.assert_array_equal(written, lut[pp])


def test_seg_evaluate_refuses_a_missing_root_and_votes_on_made_scans(
        tmp_path, minkunet):
    _, _, ckpt = minkunet
    missing = str(tmp_path / "no_such_tree")
    with pytest.raises(FileNotFoundError, match="no_such_tree"):
        seg_evaluate.evaluate(_args(missing, ckpt))
    for extra in (["--tta", "4"], ["--split", "test"]):
        with pytest.raises(ValueError, match="--synthetic"):
            seg_evaluate.evaluate(_args(missing, ckpt, "--synthetic",
                                        *extra))


def test_seg_evaluate_command_runs(tmp_path):
    """`python3 -m link_tpu_torch.tools.seg_evaluate` end to end in a fresh
    interpreter."""
    cfg = load_config(_config("minkunet"), TINY)
    caps = tuple(int(c * 1.6) for c in cfg.model.capacities)
    model = builder.make_model(cfg, capacities=caps, device="cpu",
                               generator=torch.Generator().manual_seed(1))
    ckpt = save_checkpoint(str(tmp_path), T.TrainState(
        model, builder.make_optimizer(cfg, model.parameters(), 0.1)), 1)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"      # as _one_torch_thread, for the child
    run = subprocess.run(
        [sys.executable, "-m", "link_tpu_torch.tools.seg_evaluate",
         _config("minkunet"), ckpt, "--synthetic", "--limit", "1",
         "--device", "cpu"] + TINY, cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "point-level val mIoU: " in run.stdout
    assert "1 scans on cpu: " in run.stdout
