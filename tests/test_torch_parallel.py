"""The port's data-parallel plumbing (`link_tpu_torch.parallel`,
`parallel.multihost`) against the JAX package's, and `seg_train` on 2
processes.

  * `process_shard_indices`, `stack_device_batches`, `allgather_host` and
    `gather_detections` exactly against `link_tpu.parallel(.multihost)` on
    one process and with injected process counts (as
    tests/test_multihost.py holds JAX's);
  * the same functions, `replicated`, `data_sharded`, `make_data_mesh` and
    `make_global_batch` on 2 gloo processes (tests/torch_dp_worker.py);
  * `seg_train --num-processes 2 --device cpu` on a tiny recipe (cr
    0.125, 300 points, 0.4 m voxels): rank 0 writes the only checkpoint, and
    its val mIoU equals a 1-process evaluation of that checkpoint (the
    tool's loop: every val scan alone through `seg_eval_step`) exactly.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from link_tpu import parallel as jpar
from link_tpu.parallel import multihost as jmh
from link_tpu_torch import parallel as par
from link_tpu_torch.parallel import multihost as mh
from torch_dp_worker import gather_rank, spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["model.capacities=[384,192,96,48,24]", "model.cr=0.125",
        "dataset.num_points=300", "dataset.voxel_size=0.4",
        "dataset.synthetic_length=4"]
CONFIG = os.path.join(REPO, "configs", "semantic_kitti", "linkunet",
                      "default.yaml")


@pytest.mark.parametrize("count,step", [(1, 8), (2, 8), (4, 16), (3, 6)])
def test_process_shard_indices_match_jax(count, step):
    idx = np.random.default_rng(0).permutation(103)
    for p in range(count):
        np.testing.assert_array_equal(
            mh.process_shard_indices(idx, step, p, count),
            jmh.process_shard_indices(idx, step, p, count))
    # one process: the whole of each step's window, in order
    np.testing.assert_array_equal(mh.process_shard_indices(idx, step),
                                  idx[:103 // step * step])


def test_process_shard_indices_rejects_indivisible():
    with pytest.raises(ValueError):
        mh.process_shard_indices(np.arange(10), 3, 0, 2)


def _trees(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "nested": [rng.integers(0, 9, size=(4,)),
                       rng.normal(size=(2, 2)).astype(np.float32)],
            "flag": rng.random(3) > 0.5}


def test_stack_device_batches_matches_jax():
    per = [_trees(s) for s in range(3)]
    got, want = par.stack_device_batches(per), jpar.stack_device_batches(per)
    gl = jax.tree_util.tree_leaves(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl) == 4
    for g, w in zip(gl, wl):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_allgather_host_and_gather_detections_one_process_match_jax():
    x = _trees(1)
    for g, w in zip(jax.tree_util.tree_leaves(mh.allgather_host(x)),
                    jax.tree_util.tree_leaves(jmh.allgather_host(x))):
        np.testing.assert_array_equal(g, w)
    dets = _dets(0)
    for g, w in zip(mh.gather_detections(*dets),
                    jmh.gather_detections(*dets)):
        np.testing.assert_array_equal(g, w)


def _dets(seed):
    rng = np.random.default_rng(seed)
    return (np.arange(3) + 3 * seed,
            rng.normal(size=(3, 4, 9)).astype(np.float32),
            rng.random((3, 4)).astype(np.float32),
            rng.integers(0, 10, (3, 4)).astype(np.int32),
            np.array([4, 2, 0]))


def test_one_process_mesh_and_global_batch():
    assert mh.maybe_initialize() == 0
    assert mh.maybe_initialize(num_processes=1, process_id=0) == 0
    mesh = par.make_data_mesh("cpu")
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    assert mh.local_mesh_devices(mesh) == [torch.device("cpu")]
    b = mh.make_global_batch(mesh, [{"x": np.ones((2, 3), np.float32),
                                     "n": np.int32(5), "name": "scan"}])
    assert isinstance(b["x"], torch.Tensor) and b["x"].shape == (2, 3)
    assert int(b["n"]) == 5 and b["name"] == "scan"
    with pytest.raises(ValueError):
        mh.make_global_batch(mesh, [{}, {}])
    with pytest.raises(ValueError):
        par.data_sharded(mesh, [1, 2])
    lin = torch.nn.Linear(2, 2)
    assert par.replicated(mesh, lin) is lin


@pytest.mark.parametrize("kwargs", [dict(coordinator="localhost:1"),
                                    dict(process_id=1),
                                    dict(num_processes=2, process_id=0),
                                    dict(num_processes=2,
                                         coordinator="localhost:1"),
                                    dict(num_processes=1, process_id=1)])
def test_maybe_initialize_rejects_incomplete_flags(kwargs, monkeypatch):
    """An incomplete set of flags raises before any rendezvous; nothing
    falls back to one process."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError):
        mh.maybe_initialize(**kwargs)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    inputs = {"trees": [_trees(10), _trees(11)],
              "dets": [_dets(0), _dets(1)],
              "indices": np.random.default_rng(3).permutation(50),
              "batches": [{"x": np.full((2,), r, np.float32)}
                          for r in range(2)]}
    return inputs, spawn(gather_rank, str(tmp_path_factory.mktemp("g")),
                         inputs)


def test_two_process_allgather_host(two_ranks):
    inputs, ranks = two_ranks
    want = jax.tree_util.tree_leaves(
        jpar.stack_device_batches(inputs["trees"]))
    for r, out in enumerate(ranks):
        assert out["mesh"] == (r, 2, "cpu") and out["info"] == (r, 2)
        got = jax.tree_util.tree_leaves(out["tree"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_two_process_gather_detections(two_ranks):
    inputs, ranks = two_ranks
    want = [np.concatenate(parts) for parts in zip(*inputs["dets"])]
    for out in ranks:
        for g, w in zip(out["dets"], want):
            np.testing.assert_array_equal(g, w)


def test_two_process_shards_replicas_and_batches(two_ranks):
    inputs, ranks = two_ranks
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(
            out["shard"], jmh.process_shard_indices(inputs["indices"], 4,
                                                    r, 2))
        # rank 0's weights everywhere
        assert torch.equal(out["replicated"], torch.zeros(2, 3))
        assert out["sharded"]["x"].tolist() == [r, r]
        assert torch.equal(out["global"]["x"], torch.full((2,), float(r)))


def _seg_train(args, env):
    return subprocess.Popen(
        [sys.executable, "-m", "link_tpu_torch.tools.seg_train", CONFIG,
         "--synthetic", "--device", "cpu", "--epochs", "1", *args, *TINY],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def test_seg_train_two_processes_on_the_cpu(tmp_path):
    from link_tpu_torch.data.collate import collate_scans
    from link_tpu_torch.data.semantic_kitti import SyntheticSemanticKITTI
    from link_tpu_torch.models import builder
    from link_tpu_torch.train import trainer as T
    from link_tpu_torch.train.checkpoint import load_checkpoint
    from link_tpu_torch.train.metrics import MeanIoU
    from link_tpu_torch.utils.config import load_config

    run_dir = str(tmp_path / "run")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK"):
        env.pop(var, None)
    url = "file://" + str(tmp_path / "rendezvous")
    procs = [_seg_train(["--run-dir", run_dir, "--coordinator", url,
                         "--num-processes", "2", "--process-id", str(r)],
                        env) for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "backend gloo" in outs[0] and "rank 1 of 2" in outs[1]
    assert sum(o.count("rank 0 wrote") for o in outs) == 1
    assert "rank 0 wrote" in outs[0] and "epoch 1: loss" not in outs[1]
    files = sorted(f for f in os.listdir(run_dir) if f.endswith(".pt"))
    assert files == ["best.pt", "epoch_1.pt", "latest.pt"]
    rec = [json.loads(line) for line in
           open(os.path.join(run_dir, "metrics.jsonl"))]
    assert len(rec) == 1 and np.isfinite(rec[0]["loss/train"])

    # one process: every val scan alone from the checkpoint
    cfg = load_config(CONFIG, TINY)
    caps = tuple(c * cfg.batch_size for c in cfg.model.capacities)
    model = builder.make_model(cfg, capacities=caps, device="cpu")
    state = T.TrainState(model, T.make_sgd(model.parameters(), 0.1))
    load_checkpoint(os.path.join(run_dir, "epoch_1.pt"), state)
    val = SyntheticSemanticKITTI(length=8, voxel_size=cfg.dataset.voxel_size,
                                 num_points=cfg.dataset.num_points,
                                 split="train")
    miou = MeanIoU(cfg.data.num_classes, cfg.data.ignore_label)
    for i in range(len(val)):
        b = collate_scans([val[i]], caps[0],
                          ignore_label=cfg.data.ignore_label)
        miou.update(T.seg_eval_step(model, b, cfg.data.num_classes,
                                    cfg.data.ignore_label)[1])
    assert rec[0]["iou/val"] == miou.compute()
