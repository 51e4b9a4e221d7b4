"""The port's det training targets, losses, schedules and optimizers
against the JAX package and the reference goldens.

Same numpy inputs (made from seeds) through `link_tpu.data.det_pipeline`,
`link_tpu.models.center_head`, `link_tpu.train.{schedules,det_trainer}` and
`link_tpu.models.builder`, and through their counterparts in
`link_tpu_torch`. All eager; nothing here is jitted. Tolerances:
  * targets (`limit_period`, `gaussian_radius`, `draw_umich_gaussian`,
    `assign_label`, `global_augment`, `collate_det`'s fields, the synthetic
    train frame): exact. Both sides run the same NumPy code on the same
    draws;
  * loss values against JAX: 1e-6 relative (float32, sums over the maps in
    another order), and against tests/goldens/losses.npz 1e-5 relative, the
    bound of tests/test_golden_losses.py;
  * schedules: against JAX rtol 1e-6 for one_cycle (the end-of-schedule
    floor gets atol lr_max * 1e-7) and 3e-6 for the lr_updater family, whose
    cosines of small values lose up to 1.05e-6 in JAX's float32 (the
    port's are Python floats); against the goldens the bounds of
    tests/test_golden_losses.py;
  * optimizers against optax, fed the same gradients: 1e-6 of each
    parameter's largest magnitude per step (float32, another order of the
    same operations); the fastai golden at rtol 2e-5, atol 1e-7 as
    tests/test_golden_losses.py.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from link_tpu.data import det_pipeline as jdp
from link_tpu.data.nuscenes import SyntheticNuScenes as JSynthetic
from link_tpu.models import builder as JB
from link_tpu.models import center_head as JH
from link_tpu.train import det_trainer as JDT
from link_tpu.train import schedules as JS
from link_tpu.utils.config import Config as JConfig
from link_tpu_torch.data import det_pipeline as tdp
from link_tpu_torch.data.nuscenes import SyntheticNuScenes as TSynthetic
from link_tpu_torch.models import builder as TB
from link_tpu_torch.models import center_head as TH
from link_tpu_torch.train import det_trainer as TDT
from link_tpu_torch.train import schedules as TS
from link_tpu_torch.utils.config import Config as TConfig

from torch_threads import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "losses.npz")
TINY = dict(pc_range=(-12, -12, -2, 12, 12, 2), voxel_size=(0.5, 0.5, 0.1),
            out_size_factor=2, max_objs=40)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _boxes(seed, n=30, extent=14.0):
    """Random boxes over every class, some outside the range, some with a
    zero width, yaws over several periods."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((n, 9), np.float32)
    boxes[:, 0:2] = rng.uniform(-extent, extent, (n, 2))
    boxes[:, 2] = rng.uniform(-1.5, 0.5, n)
    boxes[:, 3:6] = rng.uniform(0.3, 4.0, (n, 3))
    boxes[:, 6:8] = rng.normal(0, 2, (n, 2))
    boxes[:, 8] = rng.uniform(-3 * np.pi, 3 * np.pi, n)
    boxes[::7, 3] = 0.0
    classes = rng.integers(1, 11, n).astype(np.int32)
    return boxes, classes


def test_limit_period_and_gaussian_radius_equal_jax():
    rng = np.random.default_rng(0)
    val = rng.uniform(-20, 20, 1000)
    for off, per in ((0.5, 2 * np.pi), (0.0, np.pi), (1.0, 3.0)):
        np.testing.assert_array_equal(tdp.limit_period(val, off, per),
                                      jdp.limit_period(val, off, per))
    for h, w in rng.uniform(0.2, 60, (200, 2)):
        for ov in (0.1, 0.5, 0.7):
            for corrected in (False, True):
                assert (tdp.gaussian_radius((h, w), ov, corrected)
                        == jdp.gaussian_radius((h, w), ov, corrected))


def test_draw_umich_gaussian_equals_jax():
    rng = np.random.default_rng(1)
    a, b = np.zeros((30, 40), np.float32), np.zeros((30, 40), np.float32)
    # inside, on every edge, in the corners and past them
    centers = [(20.3, 15.7), (0, 0), (39.9, 29.9), (0, 29), (39, 0),
               (-1, 5), (45, 10)] + [tuple(c) for c in
                                     rng.uniform(0, 40, (20, 2))]
    for i, c in enumerate(centers):
        r = int(1 + i % 6)
        tdp.draw_umich_gaussian(a, np.asarray(c, np.float32), r)
        jdp.draw_umich_gaussian(b, np.asarray(c, np.float32), r)
    np.testing.assert_array_equal(a, b)
    assert a.max() == 1.0


@pytest.mark.parametrize("seed,kw", [
    (2, {}), (3, TINY), (4, dict(TINY, max_objs=5))])
def test_assign_label_equals_jax(seed, kw):
    extent = 14.0 if kw else 60.0
    boxes, classes = _boxes(seed, extent=extent)
    got = tdp.assign_label(boxes, classes, **kw)
    want = jdp.assign_label(boxes, classes, **kw)
    assert sorted(got) == sorted(want) == sorted(tdp.TARGET_KEYS)
    for key in tdp.TARGET_KEYS:
        assert len(got[key]) == len(want[key]) == 6
        for t, (g, w) in enumerate(zip(got[key], want[key])):
            assert g.dtype == w.dtype and g.shape == w.shape, (key, t)
            np.testing.assert_array_equal(g, w, err_msg=f"{key}[{t}]")
    assert sum(int(m.sum()) for m in got["mask"]) > 3


def test_global_augment_equals_jax():
    rng = np.random.default_rng(5)
    pts = rng.normal(0, 20, (2000, 5)).astype(np.float32)
    boxes, _ = _boxes(6)
    for seed in range(8):        # the four flip cases among them
        g = tdp.global_augment(pts, boxes, np.random.default_rng(seed))
        w = jdp.global_augment(pts, boxes, np.random.default_rng(seed))
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    # no boxes
    g = tdp.global_augment(pts, boxes[:0], np.random.default_rng(9))
    w = jdp.global_augment(pts, boxes[:0], np.random.default_rng(9))
    np.testing.assert_array_equal(g[0], w[0])
    assert g[1].shape == (0, 9)


def _tiny_samples(targets=True):
    rng = np.random.default_rng(7)
    out = []
    for i in range(2):
        pts = rng.uniform(-11, 11, (1500, 5)).astype(np.float32)
        v, c, n = tdp.points_to_voxel(pts, TINY["voxel_size"],
                                      TINY["pc_range"], max_points=5,
                                      max_voxels=2000)
        s = {"voxels": v, "coords_zyx": c, "num_points": n}
        if targets:
            s["targets"] = tdp.assign_label(*_boxes(10 + i), **TINY)
        out.append(s)
    return out


def test_collate_det_target_fields_equal_jax():
    samples = _tiny_samples()
    got = tdp.collate_det(samples, 4096, max_points=5)
    want = jdp.collate_det(samples, 4096, max_objs=TINY["max_objs"],
                           max_points=5)
    assert sorted(got) == sorted(want)
    for key in want:
        if isinstance(want[key], list):
            assert len(got[key]) == len(want[key]) == 6
            for g, w in zip(got[key], want[key]):
                assert g.shape[0] == 2
                np.testing.assert_array_equal(g, w, err_msg=key)
        elif key != "coords":
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # coords: the same rows, padding with the port's INVALID_COORD
    n = int(want["nnz"])
    np.testing.assert_array_equal(got["coords"][:n], want["coords"][:n])
    # the inference contract is unchanged for samples without targets
    plain = tdp.collate_det(_tiny_samples(targets=False), 4096, max_points=5)
    assert sorted(plain) == ["coords", "nnz", "num_points", "voxels"]
    on_dev = tdp.det_targets(got, "cpu")
    assert on_dev["hm"][0].dtype == torch.float32
    assert on_dev["ind"][0].dtype == torch.long
    assert on_dev["mask"][3].dtype == torch.float32


def test_synthetic_train_frame_equals_jax():
    got = TSynthetic(mode="train")[0]
    want = JSynthetic(mode="train")[0]
    for key in ("voxels", "coords_zyx", "num_points", "gt_boxes",
                "gt_classes"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in tdp.TARGET_KEYS:
        for g, w in zip(got["targets"][key], want["targets"][key]):
            np.testing.assert_array_equal(g, w, err_msg=key)
    assert got["targets"]["hm"][0].shape == (180, 180, 1)
    # the boxes are drawn after the points: the val frame's points are the
    # train frame's
    val = TSynthetic(mode="val")
    np.testing.assert_array_equal(val[0]["voxels"], got["voxels"])
    np.testing.assert_array_equal(val.points(0), TSynthetic().points(0))
    with pytest.raises(ValueError, match="mode"):
        TSynthetic(mode="test")


def test_focal_and_reg_loss_match_jax_and_golden(golden):
    out = np.transpose(golden["ff_out"], (0, 2, 3, 1))
    target = np.transpose(golden["ff_target"], (0, 2, 3, 1))
    ind = golden["ff_ind"].astype(np.int64)
    mask, cat = golden["ff_mask"], golden["ff_cat"].astype(np.int64)
    got = float(TH.fast_focal_loss(torch.from_numpy(out),
                                   torch.from_numpy(target),
                                   torch.from_numpy(ind),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(cat)))
    want = float(JH.fast_focal_loss(jnp.asarray(out), jnp.asarray(target),
                                    jnp.asarray(ind.astype(np.int32)),
                                    jnp.asarray(mask),
                                    jnp.asarray(cat.astype(np.int32))))
    ref = float(golden["ff_value"])
    assert abs(got - want) / abs(want) < 1e-6, (got, want)
    assert abs(got - ref) / abs(ref) < 1e-5, (got, ref)

    reg = np.transpose(golden["reg_out"], (0, 2, 3, 1))
    got = TH.reg_loss(torch.from_numpy(reg), torch.from_numpy(mask),
                      torch.from_numpy(ind),
                      torch.from_numpy(golden["reg_target"])).numpy()
    want = np.asarray(JH.reg_loss(jnp.asarray(reg), jnp.asarray(mask),
                                  jnp.asarray(ind.astype(np.int32)),
                                  jnp.asarray(golden["reg_target"])))
    assert _rel(got, want) < 1e-6
    np.testing.assert_allclose(got, golden["reg_value"], rtol=1e-5)


def test_focal_loss_without_positives_matches_jax():
    rng = np.random.default_rng(8)
    out = rng.uniform(1e-4, 1 - 1e-4, (2, 6, 6, 2)).astype(np.float32)
    target = rng.uniform(0, 1, (2, 6, 6, 2)).astype(np.float32)
    ind = np.zeros((2, 5), np.int64)
    mask = np.zeros((2, 5), np.uint8)
    got = float(TH.fast_focal_loss(*map(torch.from_numpy,
                                        (out, target, ind, mask, ind))))
    want = float(JH.fast_focal_loss(*map(jnp.asarray, (
        out, target, ind.astype(np.int32), mask, ind.astype(np.int32)))))
    assert abs(got - want) / abs(want) < 1e-6


def test_center_head_loss_matches_jax():
    """Random NHWC head maps against assign_label's targets of two frames,
    batch 2: the total and each task's hm / loc parts."""
    samples = _tiny_samples()
    batch = tdp.collate_det(samples, 4096, max_points=5)
    rng = np.random.default_rng(9)
    h = w = 48 // TINY["out_size_factor"]            # the 24 m range at 0.5 m
    chans = {"reg": 2, "height": 1, "dim": 3, "rot": 2, "vel": 2}
    preds = []
    for t in range(6):
        c = len(tdp.NUSC_TASKS[t])
        preds.append({k: rng.normal(0, 1, (2, h, w, n)).astype(np.float32)
                      for k, n in {**chans, "hm": c}.items()})
    tpreds = [{k: torch.from_numpy(v) for k, v in p.items()} for p in preds]
    loss, logs = TH.center_head_loss(tpreds, tdp.det_targets(batch, "cpu"))
    jex = {k: [jnp.asarray(v) for v in batch[k]] for k in tdp.TARGET_KEYS}
    jloss, jlogs = JH.center_head_loss(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in preds], jex)
    assert sorted(logs) == sorted(jlogs)
    for k in jlogs:
        assert abs(float(logs[k]) - float(jlogs[k])) <= 1e-6 * abs(
            float(jlogs[k])) + 1e-7, k
    assert float(loss) == float(logs["loss"])


def test_one_cycle_matches_jax_and_golden(golden):
    for lr_max, total, moms, div, pct in (
            (1e-3, 100, (0.95, 0.85), 10.0, 0.4),
            (3e-3, 37, (0.9, 0.8), 25.0, 0.3),
            (float(golden["oc_lr_max"]), int(golden["oc_total"]),
             (0.95, 0.85), 10.0, 0.4)):
        tl, tm = TS.one_cycle(lr_max, total, moms, div, pct)
        jl, jm = JS.one_cycle(lr_max, total, moms, div, pct)
        steps = range(total + 3)
        np.testing.assert_allclose([tl(s) for s in steps],
                                   [float(jl(s)) for s in steps],
                                   rtol=1e-6, atol=lr_max * 1e-7)
        np.testing.assert_allclose([tm(s) for s in steps],
                                   [float(jm(s)) for s in steps], rtol=1e-6)
    tl, tm = TS.one_cycle(float(golden["oc_lr_max"]), int(golden["oc_total"]))
    np.testing.assert_allclose([tl(s) for s in golden["oc_steps"]],
                               golden["oc_lr"], rtol=1e-4,
                               atol=float(golden["oc_lr_max"]) * 1e-7)
    np.testing.assert_allclose([tm(s) for s in golden["oc_steps"]],
                               golden["oc_mom"], rtol=1e-5)


def _lr_updater_cases(mod, E, spe):
    return {
        "lu_fixed_warmlin": mod.lr_updater(
            "fixed", 0.02, steps_per_epoch=spe, max_epochs=E,
            warmup="linear", warmup_iters=9, warmup_ratio=0.2),
        "lu_step_milestones": mod.lr_updater(
            "step", 0.02, steps_per_epoch=spe, max_epochs=E,
            step=[3, 7, 10], gamma=0.3),
        "lu_step_int": mod.lr_updater(
            "step", 0.02, steps_per_epoch=spe, max_epochs=E, step=4),
        "lu_poly_iter_warmexp": mod.lr_updater(
            "poly", 0.02, by_epoch=False, max_steps=E * spe, power=1.5,
            min_lr=1e-4, warmup="exp", warmup_iters=11, warmup_ratio=0.1),
        "lu_inv_iter": mod.lr_updater(
            "inv", 0.02, by_epoch=False, max_steps=E * spe, gamma=0.05,
            power=0.75),
        "lu_cosine_warmconst": mod.lr_updater(
            "cosine", 0.02, steps_per_epoch=spe, max_epochs=E,
            target_lr=1e-4, warmup="constant", warmup_iters=5,
            warmup_ratio=0.3),
        "exp": mod.lr_updater("exp", 0.02, by_epoch=False,
                              max_steps=E * spe, gamma=0.9),
    }


def test_lr_updater_family_matches_jax_and_golden(golden):
    E, spe = int(golden["lu_epochs"]), int(golden["lu_spe"])
    steps = np.arange(E * spe)
    port = _lr_updater_cases(TS, E, spe)
    ref = _lr_updater_cases(JS, E, spe)
    for key, fn in port.items():
        got = np.asarray([fn(s) for s in steps])
        np.testing.assert_allclose(got, [float(ref[key](s)) for s in steps],
                                   rtol=3e-6, err_msg=key)
        if key in golden.files:
            np.testing.assert_allclose(got, golden[key], rtol=3e-6,
                                       err_msg=key)
    with pytest.raises(ValueError, match="policy"):
        TS.lr_updater("nope", 0.1)(0)


def _leaves(seed, scale):
    rng = np.random.default_rng(seed)
    shapes = {"conv.weight": (4, 3, 3), "conv.bias": (4,), "bn.weight": (4,),
              "fc.weight": (5, 4)}
    return {k: (rng.normal(0, scale, s)).astype(np.float32)
            for k, s in shapes.items()}


def _norm(tree):
    return float(np.sqrt(sum(np.square(v.astype(np.float64)).sum()
                             for v in tree.values())))


@pytest.mark.parametrize("bn_wd", [True, False])
def test_one_cycle_adam_matches_optax(bn_wd):
    """5 steps with a changing b1 (one_cycle over 12 steps), gradient norms
    on both sides of the clip's 35 (steps 0, 2 and 4 above it), then the
    clip off. The mask variant (the groups built from `decay_mask`)
    decays only the rank >= 2 leaves, as `_decay_mask` decays flax's
    'kernel' leaves."""
    for clip in (35.0, None):
        lr_fn, mom_fn = TS.one_cycle(1e-2, 12)
        jl, jm = JS.one_cycle(1e-2, 12)
        p0 = _leaves(0, 1.0)
        model = torch.nn.Module()
        for k, v in p0.items():
            mod, leaf = k.split(".")
            if not hasattr(model, mod):
                model.add_module(mod, torch.nn.Module())
            getattr(model, mod).register_parameter(
                leaf, torch.nn.Parameter(torch.from_numpy(v.copy())))
        mask = TDT.decay_mask(model)
        assert mask == {k: v.ndim >= 2 for k, v in p0.items()}
        if bn_wd:
            opt = TDT.make_one_cycle_adam(model, lr_fn, mom_fn, 0.01,
                                          grad_clip=clip)
        else:
            named = list(model.named_parameters())
            opt = TDT.OneCycleAdam(
                [{"params": [p for k, p in named if mask[k]]},
                 {"params": [p for k, p in named if not mask[k]],
                  "weight_decay": 0.0}],
                lr_fn, mom_fn, 0.01, grad_clip=clip)
        tx = JDT.make_one_cycle_adam(jl, jm, 0.01,
                                     grad_clip=clip if clip else 1e30,
                                     bn_wd=bn_wd)
        jp = {k: {"kernel" if v.ndim >= 2 else "bias": jnp.asarray(v)}
              for k, v in p0.items()}
        state = tx.init(jp)
        named = dict(model.named_parameters())
        for step in range(5):
            g = _leaves(100 + step, 12.0 if step % 2 == 0 else 1.0)
            if clip:
                assert (_norm(g) > 35) == (step % 2 == 0)
            for k, p in named.items():
                p.grad = torch.from_numpy(g[k].copy())
            opt.step()
            jg = {k: {next(iter(jp[k])): jnp.asarray(v)}
                  for k, v in g.items()}
            upd, state = tx.update(jg, state, jp)
            jp = optax.apply_updates(jp, upd)
            for k, p in named.items():
                want = np.asarray(next(iter(jp[k].values())))
                assert _rel(p.detach().numpy(), want) < 1e-6, (clip, step, k)
        assert opt.count == 5
        # the count travels with the optimizer's state_dict
        sd = opt.state_dict()
        assert sd["param_groups"][0]["count"] == 5


def test_clip_leaves_gradients_below_the_norm_and_scales_above():
    """At b1 = 0 the first moment after one step is the clipped gradient:
    below 35 the gradient itself, above it scaled by exactly 35 / norm
    (torch's clip_grad_norm_ would divide by norm + 1e-6)."""
    for scale in (0.5, 34.9, 35.1, 40.0):
        p = torch.nn.Parameter(torch.zeros(4, 4))
        g = torch.full((4, 4), scale / 4.0)            # norm = scale
        opt = TDT.OneCycleAdam([p], lambda s: 1e-3, lambda s: 0.0,
                               weight_decay=0.0)
        p.grad = g.clone()
        opt.step()
        want = g if scale < 35 else g / g.norm() * 35.0
        torch.testing.assert_close(opt.state[p]["exp_avg"], want, rtol=0,
                                   atol=0)


def test_one_cycle_adam_matches_fastai_golden(golden):
    lrs, moms = golden["opt_lrs"], golden["opt_moms"]
    names = ["0__weight", "0__bias", "1__weight", "1__bias"]
    params = [torch.nn.Parameter(torch.from_numpy(
        np.array(golden["optp0_" + n]))) for n in names]
    opt = TDT.OneCycleAdam(params, lambda s: float(lrs[s]),
                           lambda s: float(moms[s]), weight_decay=0.01,
                           grad_clip=1e9)
    for si in range(2):
        for n, p in zip(names, params):
            p.grad = torch.from_numpy(np.array(golden[f"optg_{n}_s{si}"]))
        opt.step()
    for n, p in zip(names, params):
        np.testing.assert_allclose(p.detach().numpy(), golden["optp2_" + n],
                                   rtol=2e-5, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_make_optimizer_adam_and_adamw_match_jax(name):
    """Three steps of the builder's optimizer at a fixed lr, fed the same
    gradients; the JAX builder's optax chain on the other side."""
    base = {"optimizer": {"name": name, "lr": 0.01, "weight_decay": 0.05},
            "scheduler": {"name": "none"}}
    p0 = _leaves(1, 1.0)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in p0.items()}
    opt = TB.make_optimizer(TConfig(base), list(params.values()), 0.01)
    tx = JB.make_optimizer(JConfig(base), 0.01)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for step in range(3):
        g = _leaves(200 + step, 1.0)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            assert _rel(p.detach().numpy(), np.asarray(jp[k])) < 1e-6, (
                name, step, k)


def test_cosine_schedule_matches_jax():
    cfg = {"optimizer": {"lr": 0.3}, "scheduler": {"name": "cosine"},
           "num_epochs": 7}
    port = TB.make_lr_schedule(TConfig(cfg))
    ref = JB.make_lr_schedule(JConfig(cfg))
    steps = range(12)
    np.testing.assert_allclose([port(s) for s in steps],
                               [float(ref(s)) for s in steps], rtol=1e-6,
                               atol=1e-9)
