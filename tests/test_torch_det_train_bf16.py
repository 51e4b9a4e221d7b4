"""The port's bf16 det training against its float32 training, with the JAX
package's bounds (tests/test_det_train_bf16.py), and its bf16 step-0 loss
against the JAX package's.

`VoxelNet(dtype="bfloat16")` trains through `det_trainer.det_train_step`
with float32 parameters and one-cycle Adam state: only the compute runs in
bfloat16, as in the JAX package. The tiny VoxelNet and the two frames of
tests/test_det_train_bf16.py (grid (48, 48, 40), capacities (4096, 2048,
1024, 512), batch 1, seed 17), collated by the port; both runs start from
the port's seed-0 weights and take 10 steps of `one_cycle(1e-3, 10)`.

Bounds, the JAX test's: the step-0 losses within 3% (a pure forward on
shared weights); over the 10 steps the median relative gap below 0.25 and
the last step's below 0.3 (bf16 seeds ~1e-2 into the focal loss's chaotic
dynamics, so one step may spike); both curves end below 0.7 of their
start. The step-0 bf16 loss against the JAX package's bf16 VoxelNet
forward in train mode (one jit) on the same weights and frame: 1e-2
relative (two frameworks round the same bf16 forward otherwise).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from link_tpu.models.center_head import center_head_loss as j_loss
from link_tpu.models.voxelnet import VoxelNet as JVoxelNet
from link_tpu.utils.torch_import_det import translate_voxelnet
from link_tpu_torch.data import det_pipeline as tdp
from link_tpu_torch.models.voxelnet import VoxelNet as TVoxelNet
from link_tpu_torch.train import det_trainer as TDT
from link_tpu_torch.train import schedules as TS
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GRID = (48, 48, 40)
CAPS = (4096, 2048, 1024, 512)
PC_RANGE = (-12, -12, -2, 12, 12, 2)
VOXEL = (0.5, 0.5, 0.1)
STEPS = 10
JAX_STEP0_TOL = 1e-2


def _batch(rng, i):
    """tests/test_det_train_bf16.py's frame i, through the port's pipeline."""
    pts = rng.uniform(-11, 11, (2000, 5)).astype(np.float32)
    pts[:, 2] = rng.uniform(-1.9, 1.9, 2000)
    v, c, n = tdp.points_to_voxel(pts, VOXEL, PC_RANGE, max_points=5,
                                  max_voxels=3000)
    boxes = np.array([[0.0, 0.5 * (i + 1), 0.0, 2.0, 4.0, 1.5, 0, 0, 0.1],
                      [3.0, -2.0, 0.2, 2.2, 4.5, 1.6, 0, 0, -0.4]],
                     np.float32)
    t = tdp.assign_label(boxes, np.array([1, 1]), pc_range=PC_RANGE,
                         voxel_size=VOXEL, out_size_factor=8, max_objs=10)
    return tdp.collate_det([{"voxels": v, "coords_zyx": c, "num_points": n,
                             "targets": t}], CAPS[0], max_points=5)


def _model(dtype):
    return TVoxelNet(batch_size=1, grid_shape=GRID, capacities=CAPS,
                     dtype=dtype, device="cpu",
                     generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(17)
    return [_batch(rng, i) for i in range(2)]


@pytest.fixture(scope="module")
def curves(batches):
    """{dtype: (losses over the steps, the model after them)}."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        model = _model(dtype)
        opt = TDT.make_one_cycle_adam(model, *TS.one_cycle(1e-3, STEPS))
        losses = [float(TDT.det_train_step(model, opt,
                                           batches[t % 2])["loss"])
                  for t in range(STEPS)]
        out[dtype] = (np.asarray(losses), model, opt)
    return out


def test_bf16_det_training_tracks_float32(curves):
    l32, l16 = curves["float32"][0], curves["bfloat16"][0]
    assert np.isfinite(l32).all() and np.isfinite(l16).all(), (l32, l16)
    assert abs(l16[0] - l32[0]) / abs(l32[0]) < 0.03, (l32[0], l16[0])
    rel = np.abs(l16 - l32) / np.maximum(np.abs(l32), 1e-6)
    assert np.median(rel) < 0.25, rel
    assert rel[-1] < 0.3, rel
    assert l32[-1] < 0.7 * l32[0], l32
    assert l16[-1] < 0.7 * l16[0], l16


def test_bf16_training_keeps_float32_parameters_and_adam_state(curves):
    _, model, opt = curves["bfloat16"]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    state = [s for st in opt.state.values() for s in st.values()]
    assert len(state) == 2 * len(list(model.parameters()))
    assert all(s.dtype == torch.float32 for s in state)
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_bf16_step0_loss_matches_jax(batches, curves):
    """The port's first bf16 loss against the JAX bf16 VoxelNet's, in train
    mode (batch statistics), on the seed-0 weights and frame 0."""
    init = _model("float32")
    tree = translate_voxelnet({k: v.detach().clone().numpy()
                               for k, v in init.state_dict().items()})
    b = batches[0]
    model = JVoxelNet(num_input_features=5, batch_size=1, grid_shape=GRID,
                      capacities=CAPS, dtype="bfloat16")

    def loss(v, *a):
        preds, _ = model.apply(v, *a, True, mutable=["batch_stats"])
        example = {k: [jnp.asarray(x) for x in b[k]]
                   for k in tdp.TARGET_KEYS}
        return j_loss(preds, example)[0]

    want = float(jax.jit(loss)(tree, b["voxels"], b["coords"],
                               b["num_points"], b["nnz"]))
    got = curves["bfloat16"][0][0]
    assert abs(got - want) / abs(want) < JAX_STEP0_TOL, (got, want)
