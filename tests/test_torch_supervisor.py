"""The port's failure-recovery supervisor (`link_tpu_torch.train.supervisor`,
`link_tpu_torch.tools.train_supervisor`) with the port's `seg_train`,
mirroring tests/test_supervisor.py: the restart loop and its backoff,
`--resume auto` injection, the CLI's run-dir guard, checkpoint discovery,
resume parity of `seg_train` (one epoch, a stop and `--resume auto` equal a
straight two-epoch run), and a crashed training run relaunched to its end.
Everything is exact.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from link_tpu_torch.models.minkunet import MinkUNet
from link_tpu_torch.train.checkpoint import (checkpoint_meta, find_resume,
                                             load_checkpoint, save_checkpoint)
from link_tpu_torch.train.supervisor import inject_resume, main, supervise
from link_tpu_torch.train.trainer import TrainState, make_sgd
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "semantic_kitti", "minkunet",
                      "default.yaml")
TINY = ["--synthetic", "--device", "cpu", "--epochs", "2", "batch_size=1",
        "model.cr=0.125", "model.capacities=[384,192,96,48,24]",
        "dataset.num_points=300", "dataset.voxel_size=0.4",
        "dataset.synthetic_length=2"]

# bumps an attempt counter file, exits 3 until the counter reaches the
# requested number of crashes, then 0
CHILD = """
import sys
from pathlib import Path
p = Path(sys.argv[1])
n = int(p.read_text()) if p.exists() else 0
p.write_text(str(n + 1))
sys.exit(3 if n < int(sys.argv[2]) else 0)
"""


def _child_cmd(tmp_path, crashes):
    counter = tmp_path / "attempts"
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    return [sys.executable, str(script), str(counter), str(crashes)], counter


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return env


def test_inject_resume():
    cmd = ["python3", "-m", "link_tpu_torch.tools.seg_train", "cfg.yaml",
           "--run-dir", "r"]
    assert inject_resume(cmd) == cmd + ["--resume", "auto"]
    explicit = cmd + ["--resume", "some/ckpt.pt"]
    assert inject_resume(explicit) == explicit


def test_supervisor_restarts_until_success(tmp_path):
    cmd, counter = _child_cmd(tmp_path, crashes=2)
    delays = []
    code = supervise(cmd, max_restarts=5, backoff=0.5, resume=False,
                     log=lambda s: None, _sleep=delays.append)
    assert code == 0
    assert counter.read_text() == "3"        # 2 crashes + 1 success
    assert delays == [0.5, 1.0]              # doubling between fast crashes


def test_supervisor_gives_up(tmp_path):
    cmd, counter = _child_cmd(tmp_path, crashes=99)
    code = supervise(cmd, max_restarts=2, backoff=0.01, resume=False,
                     log=lambda s: None, _sleep=lambda s: None)
    assert code == 3
    assert counter.read_text() == "3"        # 1 launch + 2 restarts


def test_supervisor_cli_requires_stable_run_dir():
    with pytest.raises(SystemExit):
        main(["--", "python3", "-m", "link_tpu_torch.tools.seg_train",
              "cfg.yaml"])
    with pytest.raises(SystemExit):
        main([])


def test_find_resume_and_meta(tmp_path):
    def state(seed):
        model = MinkUNet(20, cr=0.125, capacities=(64,) * 5, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
        return TrainState(model, make_sgd(model.parameters(), 0.1), seed)

    d = str(tmp_path / "run")
    assert find_resume(d) is None
    save_checkpoint(d, state(1), epoch=1)
    save_checkpoint(d, state(2), epoch=2)
    rp = find_resume(d)
    assert checkpoint_meta(rp)["epoch"] == 2   # through the latest link
    got = load_checkpoint(rp, state(3))
    assert got.step == 2
    for a, b in zip(got.model.state_dict().values(),
                    state(2).model.state_dict().values()):
        assert torch.equal(a, b)
    os.remove(os.path.join(d, "latest.pt"))
    assert os.path.basename(find_resume(d)) == "epoch_2.pt"


def _seg_train(args):
    return subprocess.run(
        [sys.executable, "-m", "link_tpu_torch.tools.seg_train", CONFIG,
         *TINY, *args], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=600)


def _epoch_rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return {r["epoch"]: r for r in map(json.loads, f) if "epoch" in r}


def test_seg_train_resume_parity(tmp_path):
    """Interrupted after epoch 1 + `--resume auto` == a straight 2-epoch
    run: the checkpoint holds the whole state and the batches are seeded
    by epoch and step."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    ra = _seg_train(["--run-dir", a])
    assert ra.returncode == 0, ra.stderr[-2000:]
    rb1 = _seg_train(["--run-dir", b, "--stop-after-epoch", "1"])
    assert rb1.returncode == 0, rb1.stderr[-2000:]
    rb2 = _seg_train(["--run-dir", b, "--resume", "auto"])
    assert rb2.returncode == 0, rb2.stderr[-2000:]
    assert "resumed" in rb2.stdout and "epoch 2" in rb2.stdout
    ea, eb = _epoch_rows(a), _epoch_rows(b)
    assert set(ea) == set(eb) == {1, 2}
    for k in ("loss/train", "iou/val"):
        assert eb[2][k] == ea[2][k], k
    assert os.path.exists(os.path.join(b, "epoch_2.pt"))


def test_supervisor_end_to_end_with_seg_train(tmp_path):
    """`train_supervisor` relaunches a crashed training run and it
    completes: the first attempt stops after checkpointing epoch 1 and its
    wrapper exits 17 (a worker's death with a checkpoint on disk); the
    relaunch, given `--resume auto` by the supervisor, finishes epoch 2."""
    run_dir = str(tmp_path / "run")
    flag = tmp_path / "crashed_once"
    wrapper = tmp_path / "flaky_train.py"
    wrapper.write_text(f"""
import os, subprocess, sys
first = not os.path.exists({str(flag)!r})
cmd = [sys.executable, "-m", "link_tpu_torch.tools.seg_train", {CONFIG!r},
       *{TINY!r}] + (["--stop-after-epoch", "1"] if first else []) \\
    + sys.argv[1:]
code = subprocess.call(cmd)
if first:
    open({str(flag)!r}, "w").close()
    sys.exit(17)
sys.exit(code)
""")
    run = subprocess.run(
        [sys.executable, "-m", "link_tpu_torch.tools.train_supervisor",
         "--max-restarts", "2", "--backoff", "0.01", "--", sys.executable,
         str(wrapper), "--run-dir", run_dir], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert "child exited 17" in run.stdout and "restarting" in run.stdout
    assert "finished ok after 1 restart(s)" in run.stdout
    assert "--resume auto" in run.stdout
    rows = _epoch_rows(run_dir)
    assert set(rows) == {1, 2}               # epoch 2 ran on the relaunch
    assert all(np.isfinite(r["loss/train"]) for r in rows.values())
    assert os.path.exists(os.path.join(run_dir, "epoch_2.pt"))
