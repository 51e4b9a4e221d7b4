"""The lower-precision control at a size a test run holds: the plain
reference computed in the precision below the configuration's reads
outside the cell's limits (TF32 for the float32 training cell, float8
e4m3 for the bfloat16 inference driver), as the harness judges a run:
`Run.check` against the configuration's limits. The same control at the
cells' own sizes is `perfbench/calibrate.py`, run on the card."""

import pytest

from perfbench.tests import tiny


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_checkout(tmp_path_factory.mktemp("control"))


def _calibrate(root, workload):
    return tiny.calibrate(root, workload, 2**32 + 7)


def test_tf32_control_fails_the_training_cell(checkout):
    _, got = _calibrate(checkout, "tiny.seg")
    # judged by the harness's own check against the cell's limits
    assert got["control_tf32"]["correct"] is False
    assert got["half_batch"]["correct"] is False
    assert got["program"]["correct"] is True


def test_fp8_control_fails_the_inference_cell(checkout):
    restore = tiny.det_geometry()
    try:
        _, got = _calibrate(checkout, "tiny.det")
    finally:
        restore()
    assert got["control_fp8"]["correct"] is False
    assert got["answer_altered"]["correct"] is False
    assert got["nms_left_out"]["correct"] is False
    assert got["program"]["correct"] is True
