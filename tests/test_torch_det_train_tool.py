"""`link_tpu_torch.tools.det_train` on the CPU at the tests' tiny size.

The tool's synthetic frames cut to 3,000 points over the 48 x 48 x 40 grid
of tests/test_det_train_step.py (voxels 0.5 x 0.5 x 0.1 m) by patching the
module's `SyntheticNuScenes` and `GRID`: 8 frames an epoch at 2 a step,
voxel capacity 4,096 a frame. A run of 2 epochs, and the same run stopped
after epoch 1 and resumed with `--resume auto`, end with the same model,
Adam moments and one-cycle position, exactly: the resume continues the
schedule, not a new one.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from link_tpu_torch.data.nuscenes import SyntheticNuScenes
from link_tpu_torch.tools import det_train

from torch_threads import one_torch_thread  # noqa: F401

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "nusc",
                      "voxelnet",
                      "nusc_centerpoint_voxelnet_0075voxel_fix_bn_z_elkv3.py")
TINY = ["--synthetic", "--device", "cpu", "--voxel-capacity", "4096"]


@pytest.fixture
def tiny_frames(monkeypatch):
    monkeypatch.setattr(det_train, "GRID", (48, 48, 40))
    monkeypatch.setattr(det_train, "SyntheticNuScenes", functools.partial(
        SyntheticNuScenes, n_points=3000, pc_range=(-12, -12, -2, 12, 12, 2),
        voxel_size=(0.5, 0.5, 0.1)))


def _run(run_dir, *extra):
    assert det_train.main(TINY + ["--run-dir", str(run_dir), *extra]) == 0


def test_det_train_runs_and_resumes_the_one_cycle_position(tmp_path,
                                                           tiny_frames):
    _run(tmp_path / "straight", "--epochs", "2")
    _run(tmp_path / "split", "--epochs", "2", "--stop-after-epoch", "1")
    split = tmp_path / "split"
    assert sorted(p for p in os.listdir(split) if p.endswith(".pt")) == [
        "epoch_1.pt", "latest.pt"]
    _run(split, "--epochs", "2", "--resume", "auto")

    a = torch.load(tmp_path / "straight" / "latest.pt", weights_only=True)
    b = torch.load(split / "latest.pt", weights_only=True)
    assert a["step"] == b["step"] == 8
    assert a["optimizer"]["param_groups"][0]["count"] == 8
    for k, v in a["model"].items():
        torch.testing.assert_close(b["model"][k], v, rtol=0, atol=0,
                                   msg=k)
    for i, st in a["optimizer"]["state"].items():
        for name in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(b["optimizer"]["state"][i][name],
                                       st[name], rtol=0, atol=0)
    logs = [json.loads(line) for line in
            open(split / "metrics.jsonl").read().splitlines()]
    assert [r["epoch"] for r in logs] == [1, 2]
    assert [r["step"] for r in logs] == [4, 8]
    assert all(np.isfinite(r["loss/train"]) for r in logs)


@pytest.mark.parametrize("flags,item", [
    (["--synthetic", "--coordinator", "localhost:1234"], "item 8"),
    (["--synthetic", "--process-id", "0"], "item 8"),
    (["--dense-from-level", "0"], "item 6"),
    (["--synthetic", "--dense-from-level", "2"], "item 6"),
    (["--synthetic", "--num-processes", "2"], "item 8")])
def test_det_train_raises_on_the_unported_parts(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        det_train.main(flags + ["--device", "cpu"])


def test_det_train_takes_the_recipe_from_the_config():
    """As the JAX tool: without --config the published recipe and
    --epochs; with it the config's hyperparameters and its total_epochs,
    over --epochs."""
    rc = det_train.recipe(det_train.parse_args(["--epochs", "3"]))
    assert rc == dict(det_train.RECIPE, epochs=3)
    rc = det_train.recipe(det_train.parse_args(["--epochs", "3", "--config",
                                                CONFIG]))
    assert rc == dict(lr_max=1e-3, moms=(0.95, 0.85), div_factor=10.0,
                      pct_start=0.4, wd=0.01, clip=35.0, epochs=20)


def test_det_train_raises_on_a_dcn_head_config(tmp_path):
    """A config that asks for the DCN head, which is not ported yet, is
    refused rather than trained without it."""
    cfg = tmp_path / "dcn.py"
    cfg.write_text("model = dict(bbox_head=dict(dcn_head=True))\n")
    with pytest.raises(NotImplementedError, match="item 6"):
        det_train.main(["--synthetic", "--device", "cpu", "--config",
                        str(cfg)])
