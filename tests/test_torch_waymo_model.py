"""Port vs JAX: a tiny Waymo-task VoxelNet on `WaymoDataset` frames.

The Waymo configuration cut to a small grid: the three single-class tasks
(VEHICLE, PEDESTRIAN, CYCLIST), the Waymo pc_range (+-75.2 m, -2 to 4 m)
at 150.4 / 48 m x 150.4 / 48 m x 0.15 m voxels, so a 48 x 48 x 40 grid
and a 6 x 6 BEV, at the tests' capacities (4,096, 2,048, 1,024, 512).
Both packages build it through `build_detector`; the port's seeded weights
reach JAX through the reference layout (`translate_voxelnet`). On frames
of the port's `write_synthetic_tree` read by each package's
`WaymoDataset`:
  * the forward of a val and a train frame: every head map at rel < 2e-4
    (tests/test_torch_det_model.py's bound);
  * `decode_boxes` of JAX's maps with the Waymo test config: boxes and
    scores at 1e-6, labels and masks equal (tests/test_torch_det_serving.
    py's bounds);
  * the CenterHead loss of JAX's maps against each package's targets of
    two train frames (equal, exactly): the total and each task's parts at
    rel 1e-6 (tests/test_torch_det_targets.py's bound); of each package's
    own maps at rel 1e-4.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from link_tpu.data import waymo as jw
from link_tpu.models import builder as JB
from link_tpu.models import center_head as JH
from link_tpu.utils.torch_import_det import translate_voxelnet
from link_tpu_torch.data import det_pipeline as tdp
from link_tpu_torch.data import waymo as tw
from link_tpu_torch.models import builder as TB
from link_tpu_torch.models import center_head as TH
from link_tpu_torch.tools import create_data_waymo as tcw
from test_torch_det_model import _rel
from test_torch_nuscenes_data import assert_same
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GRID = (48, 48, 40)
CAPS = (4096, 2048, 1024, 512)
VOXEL = (150.4 / 48, 150.4 / 48, 0.15)
DATA = dict(voxel_size=VOXEL, max_voxels=(4000, 4000))
MODEL_CFG = dict(type="VoxelNet", num_input_features=5, grid_shape=GRID,
                 tasks=tw.WAYMO_TASKS, capacities=CAPS)
# the Waymo test config at this grid; the centre limit covers the range
TEST_CFG = dict(post_center_limit_range=[-80.0, -80.0, -10.0, 80.0, 80.0,
                                         10.0],
                score_threshold=0.1, pc_range=[-75.2, -75.2],
                voxel_size=list(VOXEL[:2]), out_size_factor=8)
NUM_CLASSES = [1, 1, 1]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("waymo_model"))
    tw.write_synthetic_tree(root, 2, 3000, seed=7, sequences=1)
    tcw.main(["infos", "--root", root])
    info = os.path.join(root, "infos_train_01sweeps.pkl")
    val = tw.WaymoDataset(info, root, mode="val", **DATA)
    train = {"port": tw.WaymoDataset(info, root, mode="train", seed=3,
                                     **DATA),
             "jax": jw.WaymoDataset(info, root, mode="train", seed=3,
                                    **DATA)}
    frames = {"val": val[0], "train": [train["port"][i] for i in range(2)]}
    want_train = [train["jax"][i] for i in range(2)]
    for got, want in zip(frames["train"], want_train):
        assert_same(got, want)
    port = TB.build_detector(MODEL_CFG, device="cpu",
                             generator=torch.Generator().manual_seed(5))
    sd = port.state_dict()
    for k in sd:
        if k.endswith("hm.3.bias"):        # scores about 0.5
            sd[k] = torch.zeros_like(sd[k])
    port.load_state_dict(sd)
    port.eval()
    jmodel = JB.build_detector(MODEL_CFG)
    variables = translate_voxelnet(
        {k: v.detach().clone().numpy() for k, v in sd.items()},
        tasks=(1, 1, 1))
    fwd = jax.jit(lambda v, *a: jmodel.apply(v, *a, False))
    batches = {"val": tdp.collate_det([frames["val"]], CAPS[0],
                                      max_points=5),
               "train": tdp.collate_det(frames["train"][:1], CAPS[0],
                                        max_points=5)}
    preds = {}
    for name, b in batches.items():
        with torch.inference_mode():
            got = port(*tdp.det_inputs(b, "cpu"))
        want = fwd(variables, b["voxels"], b["coords"], b["num_points"],
                   b["nnz"])
        preds[name] = (got, [{k: np.array(v) for k, v in p.items()}
                             for p in want])
    return {"frames": frames, "preds": preds, "port": port}


def test_frames_fill_the_tiny_grid(setup):
    for f in [setup["frames"]["val"], *setup["frames"]["train"]]:
        assert 500 < len(f["voxels"]) <= CAPS[0]


@pytest.mark.parametrize("name", ["val", "train"])
def test_forward_matches_jax(setup, name):
    got, want = setup["preds"][name]
    assert len(got) == len(want) == 3
    for t, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].shape == w[k].shape == (1, 6, 6, w[k].shape[-1])
            assert _rel(g[k].numpy(), w[k]) < 2e-4, (t, k)


def test_decode_matches_jax(setup):
    want_maps = setup["preds"]["val"][1]
    want = JH.decode_boxes([{k: jnp.asarray(v) for k, v in p.items()}
                            for p in want_maps], TEST_CFG, NUM_CLASSES)
    got = TH.decode_boxes([{k: torch.from_numpy(v) for k, v in p.items()}
                           for p in want_maps], TEST_CFG, NUM_CLASSES)
    kept = 0
    for t, ((gb, gs, gl, gm), (wb, ws, wl, wm)) in enumerate(zip(got,
                                                                 want)):
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        assert set(np.asarray(wl).ravel()) == {t}     # global class ids
        kept += int(gm.sum())
    assert kept > 0


def test_center_head_loss_matches_jax(setup):
    """The losses of the forward's maps of train frame 0 against the
    targets of train frames 0 and 1 (each package's, equal)."""
    frames = setup["frames"]["train"]
    batch = tdp.collate_det(frames, 2 * CAPS[0], max_points=5)
    got_maps, want_maps = setup["preds"]["train"]
    two = [{k: np.concatenate([v, v]) for k, v in p.items()}
           for p in want_maps]
    jex = {k: [jnp.asarray(v) for v in batch[k]] for k in tdp.TARGET_KEYS}
    jloss, jlogs = JH.center_head_loss(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in two], jex)
    tex = tdp.det_targets(batch, "cpu")
    loss, logs = TH.center_head_loss(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in two], tex)
    assert sorted(logs) == sorted(jlogs) and len(logs) == 7
    for k in jlogs:
        assert abs(float(logs[k]) - float(jlogs[k])) <= 1e-6 * abs(
            float(jlogs[k])) + 1e-7, k
    own = [{k: torch.cat([v, v]) for k, v in p.items()} for p in got_maps]
    own_loss, _ = TH.center_head_loss(own, tex)
    assert abs(float(own_loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    assert np.isfinite(float(loss)) and float(loss) > 0
