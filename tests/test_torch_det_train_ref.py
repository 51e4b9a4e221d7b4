"""The port's detection training step (`train/det_trainer.det_train_step`
over `VoxelNet` and `OneCycleAdam`) against the benchmark's plain reference
(`perfbench/reference/centerpoint_train.py`) on the CPU, at a tiny grid
(48 x 48 x 40, 0.5 x 0.5 x 0.1 m voxels, two made frames of 3,000 points
with a dozen boxes), on weights drawn from a seed with the reference's
init, the published widths and loss, at the capacities of
`det_capacities`:

- in float32: the loss, every leaf's gradient, and the parameters after
  one step;
- `OneCycleAdam` against the reference's Adam on the same gradients;
- in bfloat16 against the float32 reference: the loss and the median
  leaf's gradient.

Each tolerance is written beside its reason.
"""

import numpy as np
import pytest
import torch

from link_tpu_torch.data import det_pipeline as dp
from link_tpu_torch.models.scn import det_capacities
from link_tpu_torch.models.voxelnet import VoxelNet
from link_tpu_torch.train import det_trainer as DT
from perfbench import harness
from perfbench.reference import centerpoint as ref
from perfbench.reference import centerpoint_train as reft
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = {"voxel_size": [0.5, 0.5, 0.1], "pc_range": [-12, -12, -2, 12, 12, 2],
       "grid": [48, 48, 40], "max_points_in_voxel": 10,
       "max_voxels": 4000, "block_sz": 7, "elk_r": 3}
LR, B1, WD, CLIP = 1e-3, 0.85, 0.01, 35.0
SIZES = {"car": (1.95, 4.62, 1.73), "truck": (2.51, 6.93, 2.84),
         "barrier": (2.53, 0.50, 0.98), "pedestrian": (0.67, 0.73, 1.77),
         "traffic_cone": (0.41, 0.41, 1.07), "bicycle": (0.60, 1.70, 1.28)}


def _frame(seed):
    """Points (3,000 x 5) in the range, on a ground and in a dozen boxes
    of six classes."""
    rng = np.random.default_rng(seed)
    names = list(SIZES)
    boxes, classes = [], []
    for i in range(12):
        name = names[i % len(names)]
        w, l, h = SIZES[name]
        boxes.append([*rng.uniform(-9, 9, 2), rng.uniform(-1.5, -0.5), w, l, h,
                      *rng.normal(0, 2, 2), rng.uniform(-np.pi, np.pi)])
        classes.append(reft.CLASSES.index(name))
    boxes = np.asarray(boxes, np.float32)
    # a ground (a sloped plane, 5 cm thick), as a LiDAR sees one
    xy = rng.uniform(-12, 12, (1800, 2))
    pts = [np.c_[xy, -1.8 + 0.02 * xy[:, 0] + rng.uniform(0, 0.05, 1800)]]
    for b in boxes:
        pts.append(b[:3] + rng.uniform(-0.5, 0.5, (100, 3)) * b[3:6])
    xyz = np.concatenate(pts).astype(np.float32)
    feats = np.c_[xyz, rng.uniform(0, 255, len(xyz)),
                  rng.integers(0, 3, len(xyz)) * 0.05].astype(np.float32)
    return {"points": feats, "boxes": boxes,
            "classes": np.asarray(classes, np.int64)}


def _port_batch(frames):
    samples = []
    for f in frames:
        v, c, n = dp.points_to_voxel(f["points"], CFG["voxel_size"],
                                     CFG["pc_range"], 10,
                                     CFG["max_voxels"])
        samples.append({"voxels": v, "coords_zyx": c, "num_points": n,
                        "targets": dp.assign_label(
                            f["boxes"], f["classes"] + 1,
                            pc_range=CFG["pc_range"],
                            voxel_size=CFG["voxel_size"])})
    return dp.collate_det(samples, 2 * 4096)


@pytest.fixture(scope="module")
def setup():
    frames = [_frame(11), _frame(12)]
    weights = harness.draw_weights(ref.param_spec(), 2**31 + 5, "cpu")
    want = reft.train_steps(
        weights, [{"points": [f["points"] for f in frames],
                   "targets": reft.stack_targets(
                       [reft.targets(f["boxes"], f["classes"], CFG)
                        for f in frames], "cpu")}],
        CFG, LR, B1, WD, CLIP)
    return frames, weights, want


def _port_step(frames, weights, dtype):
    model = VoxelNet(batch_size=2, grid_shape=tuple(CFG["grid"]),
                     capacities=det_capacities(4096, 2), dtype=dtype,
                     device="cpu")
    sd = model.state_dict()
    model.load_state_dict({**sd, **{k: v.clone() for k, v in
                                    weights.items()}}, strict=True)
    opt = DT.make_one_cycle_adam(model, lambda c: LR, lambda c: B1,
                                 weight_decay=WD, grad_clip=CLIP)
    params = dict(model.named_parameters())
    p0 = {k: v.detach().clone() for k, v in params.items()}
    loss = float(DT.det_train_step(model, opt, _port_batch(frames))["loss"])
    grads = {k: p.grad.detach().clone() for k, p in params.items()}
    change = {k: p.detach() - p0[k] for k, p in params.items()}
    assert model.rows_dropped() == (0, 0, 0, 0)
    return loss, grads, change


def _gaps(got, want):
    """Each leaf's |a - b| / max(|b|, the median leaf's |b|) (Frobenius)."""
    med = float(np.median([float(v.norm()) for v in want.values()]))
    return {k: float((got[k] - v).norm()) / max(float(v.norm()), med)
            for k, v in want.items()}


def test_float32_step_matches_the_reference(setup):
    frames, weights, (losses, grad, after) = setup
    loss, grads, change = _port_step(frames, weights, "float32")
    # both float32, sums in other orders: the loss to 1e-5 of itself
    assert abs(loss - losses[0]) <= 1e-5 * abs(losses[0])
    gaps = _gaps(grads, grad)
    worst = max(gaps, key=gaps.get)
    # 1e-3 of a leaf's norm (or the median leaf's): BatchNorm over a few
    # hundred rows and the ELK block's LayerNorms amplify float32
    # round-off in the backward; a wrong term moves a leaf by O(1)
    assert gaps[worst] <= 1e-3, (worst, gaps[worst])
    # the update: Adam's first step is lr g / (|g| + 1e-8), about +-lr an
    # element, so an element whose gradient is float noise (each conv bias
    # before a BatchNorm, zero in exact arithmetic) may take either sign,
    # and one near 1e-8 any step below lr: held over the leaves the
    # reference's gradient moves, the median leaf at 1e-3 and the worst,
    # where a few such elements sit, at 5e-2
    med = float(np.median([float(v.norm()) for v in grad.values()]))
    moved = {k for k, v in grad.items() if float(v.norm()) >= 1e-3 * med}
    assert len(moved) > 0.8 * len(grad)
    want = {k: after[k] - weights[k] for k in moved}
    ch = _gaps({k: change[k] for k in moved}, want)
    worst = max(ch, key=ch.get)
    assert float(np.median(list(ch.values()))) <= 1e-3
    assert ch[worst] <= 5e-2, (worst, ch[worst])


def test_one_cycle_adam_matches_the_reference_adam():
    """Both optimizers on the same gradients, twice, one of them past the
    clip: the same parameters to float32 round-off (1e-6 of the
    change)."""
    gen = torch.Generator().manual_seed(3)
    p0 = {f"w{i}": torch.randn(5, 7, generator=gen) for i in range(3)}
    grads = [{k: torch.randn(v.shape, generator=gen) * s
              for k, v in p0.items()} for s in (0.5, 40.0)]
    tp = [torch.nn.Parameter(v.clone()) for v in p0.values()]
    opt = DT.OneCycleAdam(tp, lambda c: LR, lambda c: B1, weight_decay=WD,
                          grad_clip=CLIP)
    rp = {k: v.clone() for k, v in p0.items()}
    radam = reft.Adam(rp, wd=WD, clip=CLIP)
    for g in grads:
        for p, v in zip(tp, g.values()):
            p.grad = v.clone()
        opt.step()
        radam.step(g, LR, B1)
    # the clips differ (the reference's max_norm / (norm + 1e-6), the
    # port's max_norm / norm, as optax) by 1e-6 / norm of the scale, and a
    # second moment of two near-cancelling terms carries that to ~1e-5 lr
    for p, (k, v) in zip(tp, rp.items()):
        torch.testing.assert_close(p.detach() - p0[k], v - p0[k],
                                   rtol=1e-6, atol=1e-4 * LR)


def test_bfloat16_step_holds_to_the_float32_reference(setup):
    """The measure of the benchmark's check (the gap of each leaf's
    gradient norm, sign-blind): bfloat16 rounds the activations, so a
    leaf whose gradient is a sum that nearly cancels (the ELK blocks'
    LayerNorm scales) moves by its own size, and the leaves are held by
    their median."""
    frames, weights, (losses, grad, _) = setup
    loss, grads, _ = _port_step(frames, weights, "bfloat16")
    # 2.0e-3 - 2.5e-3 on two seeds: to 1e-2
    assert abs(loss - losses[0]) <= 1e-2 * abs(losses[0])
    med = float(np.median([float(v.norm()) for v in grad.values()]))
    gaps = [abs(float(grads[k].norm()) - float(v.norm()))
            / max(float(v.norm()), med) for k, v in grad.items()]
    # the median leaf read 3.2e-3 - 3.5e-3 on two seeds, and the reference
    # with its products' operands in float8 e4m3 1.2e-2 - 1.6e-2: at 8e-3
    assert float(np.median(gaps)) <= 8e-3
