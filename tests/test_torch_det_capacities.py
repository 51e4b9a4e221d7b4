"""The detector's level capacities (`models/scn.det_capacities`) and the
count of rows dropped at them (`VoxelNet.rows_dropped`), on the CPU.

- The rule: (c, c, c // 2, c // 4) with c the level-0 rows of a batch.
- A tiny VoxelNet (grid (48, 48, 40)) at the rule's capacities against the
  JAX VoxelNet at the same capacities, with shared weights, on a frame of
  scattered voxels whose strided downs grow (level 1 above half of level
  0's capacity): every head map at rel < 2e-4 (the bound of
  tests/test_torch_det_model.py), and no row dropped. The same port model
  at the old halving rule (c, c // 2, c // 4, c // 8) drops rows at levels
  1 and 2, and says so.
- The count is a device counter added to as the plans are built: a second
  forward adds the same again, `reset_rows_dropped` clears it, a model
  in inference mode counts too, and the tools' report warns while it is
  not zero.
"""

import numpy as np
import pytest
import torch

import jax

from link_tpu.models.voxelnet import VoxelNet as JVoxelNet
from link_tpu.utils.torch_import_det import translate_voxelnet
from link_tpu_torch.data import det_pipeline as dp
from link_tpu_torch.models.scn import DET_CAPACITIES, det_capacities
from link_tpu_torch.models.voxelnet import VoxelNet, report_rows_dropped

from test_torch_det_model import _reference_sd, _rel, _torch_sd
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GRID = (48, 48, 40)
CAP = 4096
OLD = (CAP, CAP // 2, CAP // 4, CAP // 8)


def test_the_rule():
    assert det_capacities(163840, 1) == DET_CAPACITIES == (163840, 163840,
                                                           81920, 40960)
    assert det_capacities(163840, 2) == (327680, 327680, 163840, 81920)


@pytest.fixture(scope="module")
def frame():
    """~1,000 voxels scattered over the grid: each reaches up to 8 outputs
    of the first strided down (k 3, s 2, p 1)."""
    rng = np.random.default_rng(9)
    pts = np.c_[rng.uniform(-12, 12, (1000, 2)), rng.uniform(-2, 2, 1000),
                rng.uniform(0, 255, 1000), np.zeros(1000)].astype(np.float32)
    v, c, n = dp.points_to_voxel(pts, (0.5, 0.5, 0.1),
                                 (-12, -12, -2, 12, 12, 2), max_points=5,
                                 max_voxels=4000)
    return dp.collate_det([{"voxels": v, "coords_zyx": c, "num_points": n}],
                          CAP, max_points=5)


def _port(sd, caps, batch, mode=torch.no_grad):
    model = VoxelNet(capacities=caps, grid_shape=GRID, device="cpu")
    model.load_state_dict(_torch_sd(sd), strict=True)
    model.eval()
    with mode():
        preds = model(*dp.det_inputs(batch, "cpu"))
    return model, preds


def test_voxelnet_at_the_rule_matches_jax_and_drops_nothing(frame):
    sd = _reference_sd()
    caps = det_capacities(CAP, 1)
    model = JVoxelNet(num_input_features=5, batch_size=1, grid_shape=GRID,
                      capacities=caps)
    want = jax.jit(lambda v, *a: model.apply(v, *a, False))(
        translate_voxelnet(sd), frame["voxels"], frame["coords"],
        frame["num_points"], frame["nnz"])
    port, got = _port(sd, caps, frame)
    assert port.rows_dropped() == (0, 0, 0, 0)
    for t, (g, w) in enumerate(zip(got, want)):
        for k in w:
            assert _rel(g[k].numpy(), w[k]) < 2e-4, (t, k)
    # the old rule's halves do not hold this frame: the port drops rows,
    # counts them, and its maps move
    old, moved = _port(sd, OLD, frame)
    dropped = old.rows_dropped()
    assert dropped[0] == 0 and dropped[1] > 0 and dropped[2] > 0
    assert max(_rel(m["hm"].numpy(), g["hm"].numpy())
               for m, g in zip(moved, got)) > 1e-3


def test_the_count_adds_up_and_resets(frame, capsys):
    sd = _reference_sd()
    model, _ = _port(sd, OLD, frame, torch.inference_mode)
    once = model.rows_dropped()
    assert sum(once) > 0
    with torch.no_grad():
        model(*dp.det_inputs(frame, "cpu"))
    assert model.rows_dropped() == tuple(2 * v for v in once)
    # what det_test and det_train print at the end of a run
    assert report_rows_dropped(model) == tuple(2 * v for v in once)
    assert "WARNING: rows dropped" in capsys.readouterr().out
    model.backbone.reset_rows_dropped()
    assert model.rows_dropped() == (0, 0, 0, 0)
    report_rows_dropped(model)
    assert "WARNING" not in capsys.readouterr().out
