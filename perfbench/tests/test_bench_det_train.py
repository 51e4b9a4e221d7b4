"""The detection training driver end to end on the CPU at a tiny size: a
sound run is correct and drops no row; the float8 control and the planted
faults (an unchanged state, half of each batch left out) read `correct`
false, as the harness judges them against the configuration's limits; and
a model whose capacities cannot hold the pool, or differ from the
configuration's, stops in set-up, before any step."""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

from perfbench.tests import tiny

CELL = "tiny.det_train"
TINY_CFG = {
    "voxel_size": [0.6, 0.6, 0.2],
    "pc_range": [-52.8, -52.8, -5.0, 52.8, 52.8, 3.0],
    "grid": [176, 176, 40], "max_voxels": 6000,
    "capacities_per_frame": [8192, 8192, 4096, 2048]}
TINY_TRAFFIC = {
    "pool_batches": 3, "sweeps": 3,
    "sensor": {"beams": 8, "azimuths": 160, "max_range_m": 40.0},
    "scene": {"scene_reach_m": 45.0}}


def make_checkout(tmp):
    """tiny.make_checkout with the tiny det training cell added."""
    root = tiny.make_checkout(tmp)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny.REPO / "perfbench/configs/"
                      "centerpoint_elkv3_nusc_bf16.json").read_text())
    (root / "perfbench/configs/tiny_centerpoint_train.json").write_text(
        json.dumps(tiny._merged(cfg, TINY_CFG)))
    tr = json.loads((tiny.REPO / "perfbench/traffic/nusc_train.json")
                    .read_text())
    (root / "perfbench/traffic/tiny_nusc_train.json").write_text(
        json.dumps(tiny._merged(tr, TINY_TRAFFIC)))
    bench["configs"].append({"name": "tiny_centerpoint_train",
                             "source": "test", "reduced": ["grid"],
                             "file": "perfbench/configs/"
                                     "tiny_centerpoint_train.json",
                             "why": "test"})
    bench["workloads"].append({"name": CELL,
                               "config": "tiny_centerpoint_train",
                               "traffic": "tiny_nusc_train", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "det_train.elkv3.bf16.b2" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return make_checkout(tmp_path_factory.mktemp("det_train"))


def _result(root, fault=None):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = tiny.run_main(root, ["--workload", CELL, "--seed",
                                  str(2**31 + 11), "--seconds", "1",
                                  "--trace", "0"], device="cpu", fault=fault)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _unchanged(state):
    real = state["step"]

    def step(model, opt, batch):
        saved = opt.step
        opt.step = lambda *a, **k: None
        try:
            return real(model, opt, batch)
        finally:
            opt.step = saved
    state["step"] = step


def _half_batch(state):
    """Each step on its first frame alone: the rows and targets of the
    second frame left out (the mean over the rest)."""
    from link_tpu_torch.sparse.coords import INVALID_COORD
    real = state["step"]

    def step(model, opt, batch):
        b = dict(batch)
        first = b["coords"][:, 3] == 0
        n = int(first[:int(b["nnz"])].sum())
        b["coords"] = b["coords"].copy()
        b["coords"][n:] = INVALID_COORD
        b["num_points"] = b["num_points"].copy()
        b["num_points"][n:] = 0
        b["nnz"] = np.int32(n)
        for key in ("hm", "anno_box", "ind", "mask", "cat"):
            b[key] = [np.concatenate([v[:1], np.zeros_like(v[1:])])
                      for v in b[key]]
        return real(model, opt, b)
    state["step"] = step


def test_sound_run_is_correct_and_drops_no_row(checkout):
    got = _result(checkout)
    assert got["correct"] is True, got["checks"]
    assert got["checks"]["rows_dropped"]["value"] == 0
    assert got["metrics"]["train_samples_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_training_faults_are_caught(checkout, fault):
    assert _result(checkout, fault)["correct"] is False


def test_fp8_control_and_faults_fail_the_limits(checkout):
    _, got = tiny.calibrate(checkout, CELL, 2**32 + 7)
    assert got["program"]["correct"] is True
    assert got["control_fp8"]["correct"] is False
    assert got["half_batch"]["correct"] is False
    assert got["unchanged_state"]["correct"] is False


def test_small_capacities_stop_the_run_in_set_up(checkout, monkeypatch):
    """A program whose level capacities cannot hold the pool (the old
    rule's halves, here far below) stops in the row audit, before the
    model takes a step."""
    from link_tpu_torch.tools import det_train
    from link_tpu_torch.train import det_trainer
    monkeypatch.setattr(det_train, "det_capacities",
                        lambda per_frame, frames: (per_frame * frames,
                                                   64, 32, 16))

    def no_step(*a, **k):
        raise AssertionError("a step ran before the row audit")
    monkeypatch.setattr(det_trainer, "det_train_step", no_step)
    with pytest.raises(RuntimeError, match="rows would be dropped"):
        _result(checkout)


def test_capacities_other_than_listed_stop_the_run(checkout, monkeypatch):
    """The configuration's `capacities_per_frame` are the model's: a model
    whose capacities hold the pool but differ from the listed ones stops
    in set-up too."""
    from link_tpu_torch.tools import det_train
    monkeypatch.setattr(det_train, "det_capacities",
                        lambda per_frame, frames: tuple(
                            2 * c * frames for c in (per_frame, per_frame,
                                                     per_frame // 2,
                                                     per_frame // 4)))
    with pytest.raises(RuntimeError, match="not the configuration's"):
        _result(checkout)
