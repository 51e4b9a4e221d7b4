"""A run with the timed path broken underneath, past the look for a card,
comes out not correct: for the training cell a step that leaves its state
unchanged and a step that leaves half its batch out (the mean over the
rest); for the inference cell an answer altered where it is produced."""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

from perfbench.tests import tiny


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_checkout(tmp_path_factory.mktemp("faults"))


def _correct(root, workload, fault):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = tiny.run_main(root, ["--workload", workload, "--seed", "12345",
                                  "--seconds", "1", "--trace", "0"],
                           device="cpu", fault=fault)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])["correct"]


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
    from link_tpu_torch.sparse.coords import INVALID_COORD
    real = state["step"]

    def step(model, opt, batch):
        b = dict(batch)
        first = b["coords"][:, 3] == 0
        n = int(first[:int(b["nnz"])].sum())
        b["coords"] = b["coords"].copy()
        b["coords"][n:] = INVALID_COORD
        b["labels"] = b["labels"].copy()
        b["labels"][n:] = 0
        b["nnz"] = np.int32(n)
        return real(model, opt, b)
    state["step"] = step


def _answer_altered(state):
    runner = state["runner"]
    real = runner.forward

    def forward(batch):
        import torch
        out = real(batch)
        with torch.inference_mode():
            for boxes, *_ in out:
                boxes[..., 0] += 0.5
        return out
    runner.forward = forward


def test_sound_runs_are_correct(checkout):
    assert _correct(checkout, "tiny.seg", None)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_training_faults_are_caught(checkout, fault):
    assert not _correct(checkout, "tiny.seg", fault)


def test_altered_answer_is_caught(checkout):
    restore = tiny.det_geometry()
    try:
        assert not _correct(checkout, "tiny.det", _answer_altered)
    finally:
        restore()
