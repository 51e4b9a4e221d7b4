"""The port's training tools on the CPU: checkpoints, the seg_train command,
the config loader and host utilities copied from the JAX package, and the
probe kernels' plain twins.

Everything here is exact (files, integers, copies) except the resumed
learning rate, compared at 1e-9 relative.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from link_tpu.data import loader as jloader
from link_tpu.utils import config as jconfig
from link_tpu_torch.data import loader as tloader
from link_tpu_torch.models import builder
from link_tpu_torch.models.linkencoder import ELKEncoder
from link_tpu_torch.models.linkunet import ELKUNet
from link_tpu_torch.models.minkunet import MinkUNet
from link_tpu_torch.models.spvcnn import SPVCNN
from link_tpu_torch.ops import kernels
from link_tpu_torch.tools import probe_gather
from link_tpu_torch.train import checkpoint as ckpt
from link_tpu_torch.train import schedules
from link_tpu_torch.train import trainer as TT
from link_tpu_torch.utils import config as tconfig
from link_tpu_torch.utils.logging import MetricsLogger, save_runtime_code
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "semantic_kitti", "linkunet",
                      "default.yaml")
TINY = ["model.capacities=[384,192,96,48,24]", "model.cr=0.125",
        "dataset.num_points=300", "dataset.voxel_size=0.4",
        "dataset.synthetic_length=4"]


def _tiny_state(seed=0):
    model = ELKUNet(20, cr=0.125, capacities=(64,) * 5, device="cpu",
                    generator=torch.Generator().manual_seed(seed))
    return TT.TrainState(model, TT.make_sgd(model.parameters(), 0.1), step=seed)


def test_checkpoint_save_rotate_best_and_resume(tmp_path):
    d = str(tmp_path / "run")
    assert ckpt.find_resume(d) is None
    state = _tiny_state(3)
    for epoch, metric in ((1, 0.2), (2, 0.5), (3, 0.4), (4, 0.45), (5, 0.1),
                          (6, 0.3)):
        state.step = 10 * epoch
        path = ckpt.save_checkpoint(d, state, epoch, metric=metric,
                                    meta={"config": "c.yaml"}, max_to_keep=4)
        assert path.endswith(f"epoch_{epoch}.pt")
    files = sorted(os.listdir(d))
    assert files == sorted(
        [f"epoch_{e}.pt" for e in (3, 4, 5, 6)]
        + [f"epoch_{e}.pt.json" for e in (3, 4, 5, 6)]
        + ["best.json", "best.pt", "latest.pt"])
    assert os.path.islink(os.path.join(d, "latest.pt"))
    assert os.readlink(os.path.join(d, "latest.pt")) == "epoch_6.pt"
    assert json.load(open(os.path.join(d, "best.json"))) == {
        "iou/val": 0.5, "epoch": 2}
    latest = ckpt.find_resume(d)
    assert latest == os.path.join(d, "latest.pt")
    assert ckpt.checkpoint_meta(latest) == {"config": "c.yaml", "epoch": 6,
                                            "iou/val": 0.3}
    # the best file outlives the rotation of its epoch file (hard link)
    best = torch.load(os.path.join(d, "best.pt"), weights_only=True)
    assert best["step"] == 20
    # a dangling latest falls back to the highest epoch file
    os.remove(os.path.join(d, "epoch_6.pt"))
    assert ckpt.find_resume(d) == os.path.join(d, "epoch_5.pt")


def test_checkpoint_round_trip_restores_model_optimizer_and_step(tmp_path):
    state = _tiny_state(1)
    for p in state.model.parameters():
        p.grad = torch.ones_like(p)
    state.optimizer.step()                      # momentum buffers exist
    state.step = 7
    path = ckpt.save_checkpoint(str(tmp_path), state, 1)
    other = ckpt.load_checkpoint(path, _tiny_state(2))
    assert other.step == 7
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              other.model.state_dict().items()):
        assert torch.equal(a, b), k
    a = state.optimizer.state_dict()["state"]
    b = other.optimizer.state_dict()["state"]
    assert a.keys() == b.keys() and len(a) > 0
    for i in a:
        assert torch.equal(a[i]["momentum_buffer"], b[i]["momentum_buffer"])


def _seg_train(run_dir, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"      # as one_torch_thread, for the child
    out = subprocess.run(
        [sys.executable, "-m", "link_tpu_torch.tools.seg_train", CONFIG,
         "--synthetic", "--device", "cpu", "--run-dir", run_dir,
         "--epochs", "3", *args, *TINY],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr + out.stdout
    return out.stdout


def test_seg_train_runs_an_epoch_and_resumes(tmp_path):
    run = str(tmp_path / "run")
    first = _seg_train(run, "--stop-after-epoch", "1")
    assert "epoch 1: loss=" in first and "val mIoU" in first
    assert "stopping after epoch 1" in first and "epoch 2" not in first
    assert os.path.exists(os.path.join(run, "epoch_1.pt"))
    assert os.path.isdir(os.path.join(run, "backup", "link_tpu_torch"))
    second = _seg_train(run, "--resume", "auto", "--stop-after-epoch", "2")
    m = re.search(r"starting at epoch (\d+), step (\d+), lr ([0-9.e+-]+)",
                  second)
    assert m, second
    # 4 scans / batch 2 = 2 steps per epoch; the schedule spans 3 epochs
    want_lr = schedules.cosine_warmup(0.24, 3, 2, 4)(2)
    assert (int(m.group(1)), int(m.group(2))) == (2, 2)
    assert abs(float(m.group(3)) - want_lr) < 1e-5 * want_lr
    assert "epoch 2: loss=" in second and "epoch 1:" not in second
    state = torch.load(os.path.join(run, "latest.pt"), weights_only=True)
    assert state["step"] == 4
    assert abs(state["optimizer"]["param_groups"][0]["lr"]
               - schedules.cosine_warmup(0.24, 3, 2, 4)(3)) < 1e-9
    lines = [json.loads(l) for l in open(os.path.join(run, "metrics.jsonl"))]
    assert [l["epoch"] for l in lines] == [1, 2]
    assert all(np.isfinite(l["loss/train"]) for l in lines)


def test_load_config_equals_the_jax_loader():
    overrides = ["model.cr=0.5", "optimizer.lr=0.1", "dataset.name=synthetic"]
    got = tconfig.load_config(CONFIG, overrides)
    want = jconfig.load_config(CONFIG, overrides)
    assert got.to_dict() == want.to_dict()
    assert got.model.name == "linkunet" and got.optimizer.lr == 0.1
    assert got.batch_size == 2 and got.data.training_size == 19132


def test_builder_makes_the_recipe():
    cfg = tconfig.load_config(CONFIG, ["model.cr=0.125"])
    model = builder.make_model(cfg, capacities=(64,) * 5, device="cpu")
    assert isinstance(model, ELKUNet) and (model.r, model.s) == (2, 3)
    lr = builder.make_lr_schedule(cfg)
    assert lr(0) == 0.24 and lr(1) < 0.24
    opt = builder.make_optimizer(cfg, model.parameters(), lr(0))
    g = opt.param_groups[0]
    assert isinstance(opt, torch.optim.SGD) and g["nesterov"]
    assert (g["lr"], g["momentum"], g["weight_decay"]) == (0.24, 0.9, 1e-4)
    # every seg family builds from its own config; SPVCNN refuses bfloat16
    for name, cls in (("minkunet", MinkUNet), ("linkencoder", ELKEncoder),
                      ("spvcnn", SPVCNN)):
        fcfg = tconfig.load_config(CONFIG.replace("linkunet", name),
                                   ["model.cr=0.125"])
        assert isinstance(builder.make_model(fcfg, capacities=(64,) * 5,
                                             device="cpu"), cls)
    with pytest.raises(ValueError, match="float32 only"):
        builder.make_model(fcfg, dtype="bfloat16", device="cpu")
    cfg.model.name = "pointnet"
    with pytest.raises(NotImplementedError):
        builder.make_model(cfg, device="cpu")


def test_loader_copies_match_the_jax_package():
    for epoch in (1, 2):
        np.testing.assert_array_equal(tloader.epoch_indices(10, epoch, 7),
                                      jloader.epoch_indices(10, epoch, 7))
    idx = np.arange(11)
    for a, b in zip(tloader.shard_indices(idx, 4),
                    jloader.shard_indices(idx, 4)):
        np.testing.assert_array_equal(a, b)
    assert list(tloader.PrefetchLoader(lambda s: s * s, 5)) == [0, 1, 4, 9, 16]


def test_metrics_logger_and_code_snapshot(tmp_path):
    log = MetricsLogger(str(tmp_path), interval=2)
    log.log_step({"loss": 1.0})
    log.log_step({"loss": 3.0})
    log.log({"epoch": 1})
    recs = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert recs[0]["loss"] == 2.0 and recs[0]["step"] == 2
    assert recs[1]["epoch"] == 1
    dst = save_runtime_code(str(tmp_path))
    assert os.path.exists(os.path.join(dst, "link_tpu_torch", "ops",
                                       "kernels.py"))
    assert not os.path.exists(os.path.join(dst, "link_tpu_torch", "_build"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_probe_row_gather_twin(dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-50, 50, (40, 6))).to(dtype)
    idx = torch.from_numpy(rng.integers(-2, 43, (100,)).astype(np.int32))
    got = kernels.probe_row_gather(x, idx)
    assert got.dtype == dtype and got.shape == (100, 6)
    for q, i in enumerate(idx.tolist()):
        want = x[i] if 0 <= i < 40 else torch.zeros(6, dtype=dtype)
        assert torch.equal(got[q], want)
    flat = kernels.probe_row_gather(x[:, 0].contiguous(), idx)   # 1-D table
    assert torch.equal(flat, got[:, 0])


def test_probe_slab_copy_and_empty_twins():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    offs = torch.tensor([0, 5, 56, 57, -1], dtype=torch.int32)
    slab = kernels.probe_slab_copy(x, offs, 8)
    assert torch.equal(slab, torch.tensor(
        [x[0, 0], x[5, 0], x[56, 0], 0.0, 0.0]))
    win = kernels.probe_slab_copy(x, offs, 8, 4).reshape(5, 4, 8)
    assert torch.equal(win[:3], torch.stack([x[o:o + 4] for o in (0, 5, 56)]))
    assert float(win[3:].abs().max()) == 0.0      # slabs that leave the table
    with pytest.raises(ValueError, match="out_rows"):
        kernels.probe_slab_copy(x, offs, 8, 9)
    tile = torch.from_numpy(rng.normal(size=(8, 128)).astype(np.float32))
    out = kernels.probe_empty(tile)
    assert torch.equal(out, tile) and out.data_ptr() != tile.data_ptr()
    with pytest.raises(ValueError, match="8, 128"):
        kernels.probe_empty(tile[:4])
    # the twins ran: nothing was launched
    assert all(fn.launches == 0 for fn in (kernels.probe_row_gather,
                                           kernels.probe_slab_copy,
                                           kernels.probe_empty))


def test_probe_tool_runs_every_small_case_on_the_twins():
    lines = []
    p = probe_gather.Probes("cpu", iters=1, reps=1, log=lines.append)
    res = p.run({"B", "C", "D", "O", "A3"})
    assert {r["letter"] for r in res} == {"B", "C", "D", "O", "A3"}
    assert len(lines) == len(res) + 2             # O prints two more lines
    for r in res:
        assert r["max_abs_err"] == 0.0 and r["ms"] > 0 and r["bound_ms"] > 0
        assert r["bound_by"] == "bytes"
    d512 = next(r for r in res if r["letter"] == "D" and r["g"] == 512)
    assert d512["payload_bytes"] == 512 * 512 * 256


def test_kernel_registry_names_every_source():
    names = [fn.__name__ for fn in kernels.KERNELS]
    assert names == ["sorted_join", "gather_conv", "window_conv",
                     "gather_wgrad", "probe_row_gather", "probe_slab_copy",
                     "probe_empty", "rotated_nms", "elk_aggregate"]
    assert {fn.source for fn in kernels.KERNELS} == set(kernels.SOURCES)
    for fn in kernels.KERNELS:
        src = open(os.path.join(kernels.CSRC, fn.source)).read()
        assert f'extern "C" int {fn.__name__}(' in src
        assert fn.replaces and fn.launches == 0
        # one ctypes argument per C parameter
        sig = src.split(f'extern "C" int {fn.__name__}(')[1].split(")")[0]
        assert len(fn.argtypes) == sig.count(",") + 1, fn.__name__
    kernels.gather_conv.launches = 3
    kernels.reset_launch_counts()
    assert kernels.gather_conv.launches == 0
