"""The port's `seg_evaluate` entry point on the CPU at a tiny size: it
restores a saved port checkpoint of each seg family, and its point-level
mIoU, its capacity-audit warning and its `.label` files equal what the
model, `seg_eval_step` and the scans' inverse maps give directly. The
capacity audit equals the JAX package's. All comparisons are exact.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from link_tpu.data import collate as jcollate
from link_tpu_torch.data import collate as tcollate
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
    lut = np.array([seg_evaluate.INVERSE_LABEL_MAP[k] for k in range(20)],
                   np.uint32)
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


def test_seg_evaluate_refuses_what_is_not_ported(tmp_path):
    base = [_config("minkunet"), str(tmp_path / "none.pt"), "--device",
            "cpu"] + TINY
    with pytest.raises(NotImplementedError, match="SemanticKITTI"):
        seg_evaluate.evaluate(seg_evaluate.parse_args(base))
    with pytest.raises(NotImplementedError, match="SemanticKITTI"):
        seg_evaluate.evaluate(seg_evaluate.parse_args(
            base + ["--synthetic", "--tta", "4"]))


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
