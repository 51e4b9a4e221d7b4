"""The port's det training step against the JAX package's, and its dense
training dynamics against the reference's recorded curve.

The tiny VoxelNet of tests/test_det_train_step.py (grid (48, 48, 40),
batch 2, capacities (8192, 4096, 2048, 1024)) on that test's two frames,
collated by each package. Shared weights: the port's seeded init, carried
to the JAX trees by `translate_voxelnet` and back into the port by
`from_jax_det_params`. One jitted `link_tpu.train.det_trainer.
make_det_train_step` serves the file; its optimizer is wrapped so that the
new optimizer state also carries the gradients the chain was fed. The
port's step is `det_trainer.det_train_step` with `make_one_cycle_adam` at
`one_cycle(1e-3, 100)`, on the CPU (the kernels' plain twins).

Bounds (float32 on both sides, ~40 sparse and dense layers, sums in
another order), each with what it measured on this setup:
  * the loss and each task's hm / loc part: 2e-5 relative (measured
    5.4e-6; the loc parts of the five tasks without a box are 0 on both
    sides);
  * each gradient leaf: 1e-4 of the leaf's largest magnitude (measured
    4.1e-5, `conv_input_bn.scale`). Leaves whose true gradient is 0 (the
    biases of convs that feed a BatchNorm: `conv1.0.conv1.bias`, the head
    branches' first conv biases, ...) hold float noise of either sign on
    both sides, at most 6.2e-6 where the largest gradient is 367 and the
    smallest real leaf's 6.6e-3: a leaf whose largest gradient is below
    1e-7 of the largest of all is bounded against that largest instead
    (measured 2.4e-8);
  * the parameters after one step: Adam's first update is lr * g / (|g| +
    1e-8), a sign where |g| >> 1e-8, so an entry whose gradient lies within
    the two packages' difference may step either way. Where |g| is above
    the gradient bound, 1e-4 of its leaf's maximum (of the largest
    gradient, for a leaf whose gradient is 0 up to noise), the parameters
    agree to 1e-6 of the leaf's magnitude plus 0.05 lr (measured 0.0078
    lr, where |g| is small enough that the update is not yet a sign).
    Below it, and with a threshold of 1e-6 instead, single entries of
    `down3.0.weight` step the other way (measured 1.95 lr): they are held
    to 2 lr;
  * the batch statistics after one step, sparse (the backbone's masked
    BatchNorms) and dense (the RPN's and head's, which move by the biased
    variance in both packages): 1e-5 of the buffer's largest magnitude
    (measured 3.3e-7 sparse, 4.3e-6 dense);
  * the window-or-gather form of every sparse conv, in order, in train
    mode: the same in both packages (7 window-form convs at level 0);
  * the 40-step f64 replay of tests/goldens/det_train_ab.npz: the bounds
    of tests/test_det_convergence_ab.py.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from link_tpu.data import det_pipeline as jdp
from link_tpu.models.voxelnet import VoxelNet as JVoxelNet
from link_tpu.sparse import conv as jconv
from link_tpu.train import det_trainer as JDT
from link_tpu.train import schedules as JS
from link_tpu.train.trainer import TrainState as JTrainState
from link_tpu.utils.torch_import_det import translate_voxelnet
from link_tpu_torch.data import det_pipeline as tdp
from link_tpu_torch.models.center_head import (CenterHead, center_head_loss,
                                               decode_boxes)
from link_tpu_torch.models.rpn import RPN
from link_tpu_torch.models.voxelnet import VoxelNet as TVoxelNet
from link_tpu_torch.ops import kernels as tk
from link_tpu_torch.train import det_trainer as TDT
from link_tpu_torch.train import schedules as TS
from link_tpu_torch.utils.convert import from_jax_det_params, grads_state_dict

from torch_threads import one_torch_thread  # noqa: F401

GRID = (48, 48, 40)
CAPS = (8192, 4096, 2048, 1024)
PC_RANGE = (-12, -12, -2, 12, 12, 2)
VOXEL = (0.5, 0.5, 0.1)
LR = (1e-3, 100)               # one_cycle(lr_max, total_steps)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "det_train_ab.npz")
GOLDEN_TASKS = (("car",), ("truck", "bus"))
CODE_W = (1.0,) * 6 + (0.2, 0.2, 1.0, 1.0)
GRAD_TOL = 1e-4                # a gradient leaf, of its largest magnitude
ZERO_LEAF = 1e-7               # a leaf's largest gradient, of the largest


def _frames(pipeline):
    """tests/test_det_train_step.py's two frames through `pipeline`'s
    voxelizer and targets."""
    rng = np.random.default_rng(70)
    samples = []
    for i in range(2):
        pts = rng.uniform(-11, 11, (3000, 5)).astype(np.float32)
        pts[:, 2] = rng.uniform(-1.9, 1.9, 3000)
        v, c, n = pipeline.points_to_voxel(pts, VOXEL, PC_RANGE,
                                           max_points=5, max_voxels=4000)
        boxes = np.array([[0.0, 2.0 * i, 0.0, 2.0, 4.0, 1.5, 0, 0, 0.1]],
                         np.float32)
        t = pipeline.assign_label(boxes, np.array([1]), pc_range=PC_RANGE,
                                  voxel_size=VOXEL, out_size_factor=8,
                                  max_objs=10)
        samples.append({"voxels": v, "coords_zyx": c, "num_points": n,
                        "targets": t})
    return samples


def _port_model(sd):
    model = TVoxelNet(batch_size=2, grid_shape=GRID, capacities=CAPS,
                      device="cpu")
    model.load_state_dict(sd, strict=True)
    return model


def _stash_grads(real):
    """`make_one_cycle_adam` whose state also carries the last gradients
    it was fed: (chain state, grads)."""
    def make(*a, **kw):
        tx = real(*a, **kw)

        def init(params):
            return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like,
                                                           params)

        def update(grads, state, params=None):
            upd, inner = tx.update(grads, state[0], params)
            return upd, (inner, grads)

        return optax.GradientTransformation(init, update)
    return make


@pytest.fixture(scope="module")
def steps():
    """One step of each package from the same weights on the same frames:
    the JAX step's (state, metrics, gradients, conv forms) and the port's
    (model before and after, optimizer, metrics, conv forms)."""
    init = TVoxelNet(batch_size=2, grid_shape=GRID, capacities=CAPS,
                     device="cpu", generator=torch.Generator().manual_seed(0))
    ref_sd = {k: v.detach().numpy().copy()
              for k, v in init.state_dict().items()}
    variables = translate_voxelnet(ref_sd)
    shared = from_jax_det_params(variables["params"],
                                 variables["batch_stats"])

    jbatch = jdp.collate_det(_frames(jdp), voxel_capacity=CAPS[0],
                             max_objs=10, max_points=5)
    gbatch = {k: np.asarray(jbatch[k])[None]
              for k in ("voxels", "coords", "num_points", "nnz")}
    for key in tdp.TARGET_KEYS:
        gbatch[key] = [np.asarray(v)[None] for v in jbatch[key]]
    model = JVoxelNet(num_input_features=5, batch_size=2, grid_shape=GRID,
                      capacities=CAPS)
    lr_fn, mom_fn = JS.one_cycle(*LR)
    real = JDT.make_one_cycle_adam
    JDT.make_one_cycle_adam = _stash_grads(real)
    try:
        init_fn, jstep = JDT.make_det_train_step(model, lr_fn, mom_fn,
                                                 mesh=None)
    finally:
        JDT.make_one_cycle_adam = real
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JTrainState(step=jnp.int32(0), params=params,
                        batch_stats=jax.tree_util.tree_map(
                            jnp.asarray, variables["batch_stats"]),
                        opt_state=init_fn(params))
    jforms = []
    win, gm = jconv._win_apply_impl, jconv._gm_impl

    def j_win(feats, weight, *a):
        jforms.append(("window", feats.shape[1], weight.shape[2]))
        return win(feats, weight, *a)

    def j_gm(feats, weight, idx):
        jforms.append(("gather", feats.shape[1], weight.shape[2]))
        return gm(feats, weight, idx)

    jconv._win_apply_impl, jconv._gm_impl = j_win, j_gm
    try:                       # the trace runs inside the first call
        new_state, jmetrics = jstep(state, gbatch)
    finally:
        jconv._win_apply_impl, jconv._gm_impl = win, gm
    jmetrics = {k: float(v) for k, v in jmetrics.items()}

    port = _port_model(shared)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    opt = TDT.make_one_cycle_adam(port, *TS.one_cycle(*LR))
    tforms = []
    orig = (tk.window_conv, tk.gather_conv)

    def spy(kind, fn):
        def wrapped(feats, *a):
            tforms.append((kind, feats.shape[1], a[-1].shape[2]))
            return fn(feats, *a)
        return wrapped

    tk.window_conv, tk.gather_conv = spy("window", orig[0]), spy("gather",
                                                                orig[1])
    try:
        tbatch = tdp.collate_det(_frames(tdp), CAPS[0], max_points=5)
        tmetrics = TDT.det_train_step(port, opt, tbatch)
    finally:
        tk.window_conv, tk.gather_conv = orig
    return dict(jstate=new_state, jmetrics=jmetrics,
                jgrads=new_state.opt_state[1], jforms=jforms,
                port=port, before=before, opt=opt,
                tmetrics={k: float(v) for k, v in tmetrics.items()},
                tforms=tforms, variables=variables)


def _leaf_rel(got, want, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()
                 / max(np.abs(want).max(), floor, 1e-30))


def test_loss_and_its_parts_match_jax(steps):
    t, j = steps["tmetrics"], steps["jmetrics"]
    assert sorted(t) == sorted(j) and len(t) == 13
    for k, v in j.items():
        assert abs(t[k] - v) <= 2e-5 * abs(v), (k, t[k], v)
    assert t["loss"] > 0


def test_every_gradient_leaf_matches_jax(steps):
    tree = translate_voxelnet(grads_state_dict(steps["port"]))["params"]
    got = jax.tree_util.tree_leaves_with_path(tree)
    want = jax.tree_util.tree_leaves_with_path(steps["jgrads"])
    assert [p for p, _ in got] == [p for p, _ in want]
    top = max(float(np.abs(np.asarray(w)).max()) for _, w in want)
    worst = {}
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        zero = np.abs(w).max() < ZERO_LEAF * top
        err = _leaf_rel(g, w, floor=top if zero else 0.0)
        worst[jax.tree_util.keystr(path)] = err
        assert err < GRAD_TOL, (jax.tree_util.keystr(path), err, zero)
    assert len(worst) > 150


def test_parameters_after_one_step_match_jax(steps):
    """The sign rule of Adam's first step: see the module docstring."""
    lr = TS.one_cycle(*LR)[0](0)
    jnew = from_jax_det_params(steps["jstate"].params,
                               steps["jstate"].batch_stats)
    grads = dict(steps["port"].named_parameters())
    top = max(float(p.grad.abs().max()) for p in grads.values()
              if p.grad is not None)
    checked = 0
    for k, p in grads.items():
        got = p.detach().numpy()
        want = jnew[k].numpy()
        g = (np.abs(p.grad.numpy()) if p.grad is not None
             else np.zeros_like(got))
        # a leaf whose gradient is 0 up to noise has no sure sign
        scale = g.max() if g.max() >= ZERO_LEAF * top else top
        sure = g > GRAD_TOL * scale
        if sure.any():
            d = np.abs(got - want)[sure]
            assert d.max() <= 1e-6 * np.abs(want).max() + 0.05 * lr, (
                k, d.max())
            checked += 1
        assert np.abs(got - want).max() <= 2 * lr, k
        # the step moved every parameter (decoupled decay moves even those
        # without a gradient)
        assert not np.array_equal(got, steps["before"][k].numpy()) or \
            not np.any(steps["before"][k].numpy()), k
    assert checked > 150


def test_batch_statistics_after_one_step_match_jax(steps):
    jnew = from_jax_det_params(steps["jstate"].params,
                               steps["jstate"].batch_stats)
    sd = steps["port"].state_dict()
    keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    dense = [k for k in keys if not k.startswith("backbone.")]
    assert len(dense) > 40 and len(keys) - len(dense) > 40
    for k in keys:
        got, want = sd[k].numpy(), jnew[k].numpy()
        assert _leaf_rel(got, want) < 1e-5, k
        assert not np.array_equal(got, steps["before"][k].numpy()), k


def test_same_window_or_gather_form_for_every_conv_in_training(steps):
    jforms, tforms = steps["jforms"], steps["tforms"]
    assert len(jforms) == 33
    assert tforms[:33] == jforms
    assert sum(kind == "window" for kind, _, _ in jforms) == 7
    # the backward: the feature gradients of the 6 window-form convs whose
    # input needs one (not the stem's) through window_conv, the others
    # through gather_conv
    back = tforms[33:]
    assert sum(kind == "window" for kind, _, _ in back) == 6
    assert len(back) == 32


def test_predict_step_decodes_the_trained_model(steps):
    """`det_predict_step` is the eval-mode forward and `decode_boxes`."""
    port = steps["port"]
    batch = tdp.collate_det(_frames(tdp), CAPS[0], max_points=5)
    cfg = {"pc_range": PC_RANGE[:2], "voxel_size": VOXEL[:2],
           "out_size_factor": 8, "score_threshold": 0.1,
           "post_center_limit_range": (-15, -15, -5, 15, 15, 5)}
    got = TDT.det_predict_step(port, batch, cfg)
    assert not port.training
    with torch.no_grad():
        want = decode_boxes(port(*tdp.det_inputs(batch, "cpu")), cfg,
                            port.bbox_head.num_classes)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g[0].shape == (2, 36, 9)
        for a, b in zip(g, w):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_decay_mask_matches_jax(steps):
    """bn_wd=False's mask, through the reference layout, equals
    `_decay_mask` on the JAX tree (the published recipe decays all)."""
    port = steps["port"]
    mask = TDT.decay_mask(port)
    sd = {k: np.full(v.shape, float(mask.get(k, 0.0)), np.float32)
          for k, v in port.state_dict().items()}
    tree = translate_voxelnet(sd)["params"]
    want = JDT._decay_mask(steps["variables"]["params"])
    got = jax.tree_util.tree_leaves_with_path(tree)
    ref = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, g), (_, w) in zip(got, ref):
        assert np.all(np.asarray(g) == float(w)), jax.tree_util.keystr(path)
    assert 0 < sum(mask.values()) < len(mask)


def _golden_model(g):
    neck = RPN(layer_nums=(2, 2), ds_layer_strides=(1, 2),
               ds_num_filters=(32, 64), us_layer_strides=(1, 2),
               us_num_filters=(32, 32), num_input_features=32,
               dtype="float64", device="cpu").double()
    head = CenterHead(in_channels=64, tasks=GOLDEN_TASKS,
                      share_conv_channel=32, dtype="float64",
                      device="cpu").double()
    sd = {k[3:].replace("__", "."): torch.from_numpy(np.array(g[k]))
          for k in g.files if k.startswith("sd_")}
    for prefix, mod in (("neck.", neck), ("bbox_head.", head)):
        mod.load_state_dict({k[len(prefix):]: v.double()
                             if v.is_floating_point() else v
                             for k, v in sd.items()
                             if k.startswith(prefix)}, strict=True)
    return neck, head


def test_det_training_matches_reference_curve():
    """tests/test_det_convergence_ab.py through the port: the reference
    dense det composite's 40 steps in float64, eagerly, with
    `OneCycleAdam` fed the recorded lr and momentum curves."""
    g = np.load(GOLDEN)
    assert str(g["dtype"]) == "float64"
    steps, n_frames = int(g["steps"]), int(g["n_frames"])
    ref = np.asarray(g["losses"])
    lrs, moms = np.asarray(g["lrs"]), np.asarray(g["moms"])
    lr_fn, mom_fn = TS.one_cycle(float(g["lr_max"]), steps)
    np.testing.assert_allclose([lr_fn(s) for s in range(steps)], lrs,
                               rtol=2e-5, atol=1e-10)
    np.testing.assert_allclose([mom_fn(s) for s in range(steps)], moms,
                               rtol=2e-5)
    neck, head = _golden_model(g)
    frames = []
    for i in range(n_frames):
        ex = {"bev": torch.from_numpy(g[f"frame{i}_bev"]).double()}
        for k in tdp.TARGET_KEYS:
            dt = torch.float64 if k in ("hm", "anno_box", "mask") else \
                torch.long
            ex[k] = [torch.from_numpy(np.array(g[f"frame{i}_{k}{t}"]))
                     .to(dt)[None] for t in range(len(GOLDEN_TASKS))]
        frames.append(ex)
    params = list(neck.parameters()) + list(head.parameters())
    opt = TDT.OneCycleAdam(params, lambda s: float(lrs[s]),
                           lambda s: float(moms[s]), weight_decay=0.01,
                           grad_clip=35.0)
    neck.train()
    head.train()
    losses = []
    for it in range(steps):
        ex = frames[it % n_frames]
        opt.zero_grad(set_to_none=True)
        loss, _ = center_head_loss(head(neck(ex["bev"])), ex, 0.25, CODE_W)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    losses = np.asarray(losses)
    err = np.abs(losses - ref)
    tol = 1e-7 + 1e-13 * 1.5 ** np.arange(steps) + 1e-6 * ref
    assert (err <= tol).all(), (
        f"det loss curve diverged: max err {err.max():.3e} at step "
        f"{err.argmax()}")
