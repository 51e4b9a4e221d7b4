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
from link_tpu_torch.models.scn import det_capacities
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


@pytest.mark.parametrize("flags,missing", [
    (["--synthetic", "--coordinator", "localhost:1234"], "--num-processes"),
    (["--synthetic", "--process-id", "0"], "--num-processes"),
    (["--num-processes", "4", "--process-id", "1"], "--coordinator"),
    (["--synthetic", "--dense-from-level", "2", "--coordinator",
      "localhost:1234"], "--num-processes"),
    (["--synthetic", "--num-processes", "2"], "--process-id")])
def test_det_train_raises_on_the_unported_parts(flags, missing, monkeypatch):
    """The multi-process flags are ported (`parallel.multihost`); an
    incomplete set of them raises before any rendezvous or training,
    naming what is missing, whatever else is asked for (torchrun's
    environment, which could fill the gap, is cleared)."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match=missing):
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


def test_det_train_trains_a_dcn_head_config(tmp_path, tiny_frames):
    """A config that asks for the DCN head (the published config with
    bbox_head.dcn_head=True) trains a VoxelNet with a DCNSepHead per task:
    one epoch (stopped, the config's schedule spans 20), its checkpoint
    holds the DCN head's reference keys, every one of its parameters moved,
    and the loss is finite."""
    cfg = tmp_path / "dcn.py"
    cfg.write_text(open(CONFIG).read()
                   + "\nmodel['bbox_head']['dcn_head'] = True\n")
    _run(tmp_path / "run", "--config", str(cfg), "--stop-after-epoch", "1")
    ckpt = torch.load(tmp_path / "run" / "latest.pt", weights_only=True)
    sd = ckpt["model"]
    key = "bbox_head.tasks.0.feature_adapt_cls.conv_adaption.weight"
    assert key in sd and not any(".hm." in k for k in sd)
    init = det_train.VoxelNet(batch_size=2, grid_shape=(48, 48, 40),
                              capacities=det_capacities(4096, 2),
                              dcn_head=True, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    for k, v in init.state_dict().items():
        if ".tasks." in k and not k.endswith("num_batches_tracked"):
            assert not torch.equal(sd[k], v), k
    logs = [json.loads(line) for line in
            open(tmp_path / "run" / "metrics.jsonl").read().splitlines()]
    assert [r["epoch"] for r in logs] == [1]
    assert np.isfinite(logs[0]["loss/train"])


def test_det_train_with_dense_from_level(tmp_path, tiny_frames):
    """--dense-from-level 2 trains the hybrid backbone: one epoch, finite
    loss, and the dense levels' weights moved."""
    _run(tmp_path / "run", "--epochs", "1", "--dense-from-level", "2")
    sd = torch.load(tmp_path / "run" / "latest.pt",
                    weights_only=True)["model"]
    init = det_train.VoxelNet(batch_size=2, grid_shape=(48, 48, 40),
                              capacities=det_capacities(4096, 2),
                              device="cpu",
                              generator=torch.Generator().manual_seed(0))
    for k in ("backbone.conv3.0.conv1.weight", "backbone.down4.0.weight",
              "backbone.elk4.pre_mix.0.weight",
              "backbone.extra_conv.0.weight"):
        assert not torch.equal(sd[k], init.state_dict()[k]), k
    logs = [json.loads(line) for line in
            open(tmp_path / "run" / "metrics.jsonl").read().splitlines()]
    assert np.isfinite(logs[0]["loss/train"]) and logs[0]["step"] == 4
