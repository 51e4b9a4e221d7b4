"""Port vs JAX and the reference golden: the two-stage refinement
(`models/two_stage.py`), `tools/det_train_two_stage` and `det_test
--two-stage`.

  * `RoIHead` with the reference state_dict of tests/goldens/det_roi.npz
    (its `roisd_*` keys load directly) and `generate_refined_boxes` against
    the reference's iou logits and boxes, and the 5-point BEV pooling
    against its pooled features: the bounds of
    tests/test_golden_det_dense.py (rtol 1e-4; atol 1e-5, 1e-4 for boxes);
  * `assign_roi_targets` draw for draw equal to JAX's with the same
    `default_rng` seed (host NumPy in both: exactly);
  * `bilinear_interpolate`, `box_sample_points`, `generate_refined_boxes`,
    `roi_losses` and `second_stage_score` against eager JAX: 1e-6 relative;
  * one refinement train step (`det_train_two_stage.refine_step`, one-cycle
    Adam at wd 0.01, clip 35) against JAX's (`jax.value_and_grad` of the
    same losses, `make_one_cycle_adam`): losses 1e-5 relative, each
    gradient 1e-4 of its largest magnitude, the BN statistics after the
    step 1e-5;
  * `det_train_two_stage --synthetic --gt-proposals` and `det_test
    --two-stage` (its seed-1 refinement, and the tool's checkpoint through
    --two-stage-checkpoint) at the tests' tiny grid, by patching the tools'
    `GRID`, `CAPACITY`, `TEST_CFG` and datasets: the first stage's maps and
    BEV against the jitted JAX VoxelNet(return_bev=True) on the same batch
    and weights (rel 2e-4, the tiny VoxelNet's bound in
    tests/test_torch_det_model.py), and the refined scores and boxes of
    each frame's proposals against the JAX TwoStageRefinement with the same
    weights (rtol 1e-4, atol 1e-5).
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from link_tpu.models import two_stage as J
from link_tpu.models.voxelnet import VoxelNet as JVoxelNet
from link_tpu.train import det_trainer as JDT
from link_tpu.train import schedules as JS
from link_tpu.utils.torch_import_det import translate_voxelnet
from link_tpu_torch.data import det_pipeline as tdp
from link_tpu_torch.data.nuscenes import SyntheticNuScenes
from link_tpu_torch.inference import host_nms, masked_rows
from link_tpu_torch.models import two_stage as T
from link_tpu_torch.models.scn import det_capacities
from link_tpu_torch.tools import det_test, det_train_two_stage
from link_tpu_torch.train import det_trainer as TDT
from link_tpu_torch.train import schedules as TS
from link_tpu_torch.utils.convert import from_jax_two_stage

from test_torch_det_test_tool import GRID, TINY_CFG, tiny, tree  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "det_roi.npz")
MAP_TOL = 2e-4


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def test_roi_head_matches_the_reference_golden():
    z = np.load(GOLDEN)
    sd = {k[6:].replace("__", "."): torch.from_numpy(np.array(z[k]))
          for k in z.files if k.startswith("roisd_")}
    head = T.RoIHead(input_channels=128, device="cpu")
    head.load_state_dict(sd, strict=True)
    head.eval()
    with torch.no_grad():
        iou, reg = head(torch.from_numpy(z["roi_feats"][0]))
        boxes = T.generate_refined_boxes(torch.from_numpy(z["roi_rois"][0]),
                                         reg)
    np.testing.assert_allclose(iou.numpy(), z["roi_cls"][0, :, 0],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(boxes.numpy(), z["roi_boxes"][0], rtol=1e-4,
                               atol=1e-4)


def test_bev_pooling_matches_the_reference_golden():
    z = np.load(GOLDEN)
    pts = T.box_sample_points(torch.from_numpy(z["bev_boxes"]))
    pooled = T.BEVFeatureExtractor((-6.0, -6.0), (0.5, 0.5), 1)(
        torch.from_numpy(z["bev_map"]), pts)
    np.testing.assert_allclose(pooled.numpy(), z["bev_pooled"], rtol=1e-4,
                               atol=1e-5)


def _boxes(rng, n, spread=8.0):
    b = np.zeros((n, 9), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(1, 4, (n, 3))
    b[:, 6:8] = rng.normal(0, 1, (n, 2))
    b[:, 8] = rng.uniform(-np.pi, np.pi, n)
    return b


def _proposals(seed, n_gt=6, n_roi=60, jitter=0.3):
    """GT boxes (det3d layout) and proposals around them, some jittered
    (foreground), some elsewhere (background), as the roi layout."""
    rng = np.random.default_rng(seed)
    gt = _boxes(rng, n_gt)
    near = np.repeat(gt, n_roi // (2 * n_gt), 0)
    near = near + rng.normal(0, jitter, near.shape).astype(np.float32)
    far = _boxes(rng, n_roi - len(near), 20.0)
    rois = J.reorder_to_roi_layout(np.concatenate([near, far]))
    scores = rng.uniform(0, 1, len(rois)).astype(np.float32)
    labels = rng.integers(0, 10, len(rois))
    return rois, scores, labels, gt, rng.integers(0, 10, n_gt)


@pytest.mark.parametrize("case", ["mixed", "fg_only", "bg_only", "no_gt",
                                  "no_rois"])
def test_assign_roi_targets_draw_for_draw(case):
    rois, scores, labels, gt, gtc = _proposals(7)
    if case == "fg_only":
        rois, scores, labels = rois[:30], scores[:30], labels[:30]
        rois = J.reorder_to_roi_layout(np.repeat(gt, 5, 0))
        scores, labels = scores[:len(rois)], labels[:len(rois)]
    elif case == "bg_only":
        rois, scores, labels = rois[30:], scores[30:], labels[30:]
    elif case == "no_gt":
        gt, gtc = gt[:0], gtc[:0]
    elif case == "no_rois":
        rois, scores, labels = rois[:0], scores[:0], labels[:0]
    got = T.assign_roi_targets(rois, scores, labels, gt, gtc,
                               np.random.default_rng(11))
    want = J.assign_roi_targets(rois, scores, labels, gt, gtc,
                                np.random.default_rng(11))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if case == "mixed":
        assert got["reg_mask"].sum() > 0 and (got["cls_labels"] == 0).any()


def test_second_stage_functions_match_jax():
    rng = np.random.default_rng(12)
    fmap = rng.normal(size=(10, 12, 4)).astype(np.float32)
    xs = rng.uniform(-2, 14, 50).astype(np.float32)    # some off the map
    ys = rng.uniform(-2, 12, 50).astype(np.float32)
    got = T.bilinear_interpolate(torch.from_numpy(fmap), torch.from_numpy(xs),
                                 torch.from_numpy(ys))
    want = J.bilinear_interpolate(jnp.asarray(fmap), jnp.asarray(xs),
                                  jnp.asarray(ys))
    assert _rel(got.numpy(), want) < 1e-6
    rois = J.reorder_to_roi_layout(_boxes(rng, 20))
    np.testing.assert_allclose(
        T.box_sample_points(torch.from_numpy(rois[:, :7])).numpy(),
        np.asarray(J.box_sample_points(jnp.asarray(rois[:, :7]))),
        rtol=1e-6, atol=1e-6)
    reg = rng.normal(0, 0.3, (20, 9)).astype(np.float32)
    assert _rel(T.generate_refined_boxes(torch.from_numpy(rois),
                                         torch.from_numpy(reg)).numpy(),
                J.generate_refined_boxes(jnp.asarray(rois),
                                         jnp.asarray(reg))) < 1e-6
    iou = rng.normal(size=20).astype(np.float32)
    sc = rng.uniform(0, 1, 20).astype(np.float32)
    assert _rel(T.second_stage_score(torch.from_numpy(iou),
                                     torch.from_numpy(sc)).numpy(),
                J.second_stage_score(jnp.asarray(iou), jnp.asarray(sc))) \
        < 1e-6
    labels = np.where(rng.uniform(size=20) < 0.2, -1.0,
                      rng.uniform(0, 1, 20)).astype(np.float32)
    mask = (rng.uniform(size=20) < 0.5).astype(np.float32)
    tgt = rng.normal(size=(20, 9)).astype(np.float32)
    got = T.roi_losses(*(torch.from_numpy(a) for a in
                         (iou, reg, labels, tgt, mask)))
    want = J.roi_losses(*(jnp.asarray(a) for a in
                          (iou, reg, labels, tgt, mask)))
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-6 * abs(float(w))
    b = _boxes(rng, 3)
    np.testing.assert_array_equal(T.reorder_to_roi_layout(b),
                                  J.reorder_to_roi_layout(b))
    np.testing.assert_array_equal(
        T.roi_layout_to_det3d(T.reorder_to_roi_layout(b)), b)


def to_jax_two_stage(sd):
    """The port's TwoStageRefinement state_dict -> JAX {params,
    batch_stats} (the inverse of `from_jax_two_stage`)."""
    params, stats = {}, {}
    for ours, ref in (("shared", "shared_fc_layer"), ("cls_fc", "cls_layers"),
                      ("reg_fc", "reg_layers")):
        i = 0
        # a layer's conv at 3 i + min(i, 1), its BN next (the final conv
        # has none)
        while f"roi_head.{ref}.{3 * i + min(i, 1) + 1}.weight" in sd:
            c = 3 * i + min(i, 1)
            params[f"{ours}{i}"] = {"kernel": sd[f"roi_head.{ref}.{c}.weight"]
                                    [:, :, 0].T.numpy()}
            pre = f"roi_head.{ref}.{c + 1}"
            params[f"{ours}{i}_bn"] = {"scale": sd[f"{pre}.weight"].numpy(),
                                       "bias": sd[f"{pre}.bias"].numpy()}
            stats[f"{ours}{i}_bn"] = {"mean": sd[f"{pre}.running_mean"]
                                      .numpy(),
                                      "var": sd[f"{pre}.running_var"].numpy()}
            i += 1
        if ours != "shared":
            key = f"roi_head.{ref}.{3 * i + 1}"
            params["cls" if ours == "cls_fc" else "reg"] = {
                "kernel": sd[f"{key}.weight"][:, :, 0].T.numpy(),
                "bias": sd[f"{key}.bias"].numpy()}
    return {"params": {"roi_head": params},
            "batch_stats": {"roi_head": stats}}


def test_weights_convert_both_ways():
    m = J.TwoStageRefinement(bev_channels=8)
    vs = m.init(jax.random.PRNGKey(3), jnp.zeros((6, 6, 8)),
                jnp.zeros((16, 9)), jnp.zeros((16,)), False)
    sd = from_jax_two_stage(vs["params"], vs["batch_stats"])
    port = T.TwoStageRefinement(bev_channels=8, device="cpu")
    port.load_state_dict(sd, strict=True)
    back = to_jax_two_stage(port.state_dict())
    for tree_name in ("params", "batch_stats"):
        a = jax.tree_util.tree_leaves_with_path(vs[tree_name])
        b = jax.tree_util.tree_leaves_with_path(back[tree_name])
        assert [p for p, _ in a] == [p for p, _ in b]
        for (p, x), (_, y) in zip(a, b):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                          jax.tree_util.keystr(p))


def test_refinement_train_step_matches_jax():
    z = np.load(GOLDEN)
    bev = z["bev_map"]                                   # (24, 24, 8)
    rois, scores, labels, gt, gtc = _proposals(13)
    t = T.assign_roi_targets(rois, scores, labels, gt, gtc,
                             np.random.default_rng(1))
    kw = dict(pc_start=(-6.0, -6.0), voxel_size=(0.5, 0.5), out_stride=1)
    jm = J.TwoStageRefinement(bev_channels=8, **kw)
    port = T.TwoStageRefinement(bev_channels=8, device="cpu",
                                generator=torch.Generator().manual_seed(1),
                                **kw)
    vs = to_jax_two_stage(port.state_dict())
    lr_fn, mom_fn = JS.one_cycle(3e-4, 10)
    tx = JDT.make_one_cycle_adam(lr_fn, mom_fn, weight_decay=0.01,
                                 grad_clip=35.0)
    params = jax.tree_util.tree_map(jnp.asarray, vs["params"])
    args = [jnp.asarray(t[k]) for k in ("rois", "roi_scores")]
    tgt = [jnp.asarray(t[k]) for k in ("cls_labels", "gt_of_rois",
                                       "reg_mask")]

    def loss_fn(p):
        (iou, reg), mut = jm.apply({"params": p,
                                    "batch_stats": vs["batch_stats"]},
                                   jnp.asarray(bev), *args, True,
                                   mutable=["batch_stats"])
        cl, rl = J.roi_losses(iou, reg, *tgt)
        return cl + rl, (mut["batch_stats"], cl, rl)

    (jloss, (jstats, jcl, jrl)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    upd, _ = tx.update(jgrads, tx.init(params), params)
    jnew = optax.apply_updates(params, upd)

    opt = TDT.OneCycleAdam(port.parameters(), *TS.one_cycle(3e-4, 10),
                           weight_decay=0.01, grad_clip=35.0)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    port.requires_grad_(True)
    grads = {}
    real_step = opt.step

    def step():
        grads.update({k: p.grad.clone() for k, p in port.named_parameters()})
        real_step()
    opt.step = step
    loss, cl, rl = det_train_two_stage.refine_step(
        port, opt, torch.from_numpy(bev), t, "cpu")
    for g, w in ((loss, jloss), (cl, jcl), (rl, jrl)):
        assert abs(float(g) - float(w)) <= 1e-5 * abs(float(w))
    # the gradients in the parameters' layout
    jg = to_jax_two_stage({**port.state_dict(), **grads})["params"]
    jp = to_jax_two_stage(port.state_dict())
    jb = to_jax_two_stage(before)
    for path, w in jax.tree_util.tree_leaves_with_path(jgrads):
        g = functools.reduce(lambda d, k: d[k.key], path, jg)
        assert _rel(g, w) < 1e-4, jax.tree_util.keystr(path)
    for path, w in jax.tree_util.tree_leaves_with_path(jstats):
        g = functools.reduce(lambda d, k: d[k.key], path, jp["batch_stats"])
        assert _rel(g, w) < 1e-5, jax.tree_util.keystr(path)
    # every parameter moved, as JAX's did, by about its step
    lr = TS.one_cycle(3e-4, 10)[0](0)
    for path, w in jax.tree_util.tree_leaves_with_path(jnew):
        g = functools.reduce(lambda d, k: d[k.key], path, jp["params"])
        b = functools.reduce(lambda d, k: d[k.key], path, jb["params"])
        assert np.abs(np.asarray(g) - np.asarray(w)).max() <= 2 * lr
        assert not np.array_equal(g, b)


# ---------------------------------------------------------------------------
# the tools at the tiny grid


@pytest.fixture
def tiny_two_stage(monkeypatch, tiny):
    monkeypatch.setattr(det_train_two_stage, "GRID", GRID)
    monkeypatch.setattr(det_train_two_stage, "CAPACITY", 4096)
    monkeypatch.setattr(det_train_two_stage, "TEST_CFG",
                        dict(det_train_two_stage.TEST_CFG, **TINY_CFG))
    monkeypatch.setattr(det_train_two_stage, "SyntheticNuScenes",
                        functools.partial(
                            SyntheticNuScenes, n_points=3000,
                            pc_range=(-12, -12, -2, 12, 12, 2),
                            voxel_size=(0.5, 0.5, 0.1)))


@pytest.fixture(scope="module")
def jax_first_stage():
    model = JVoxelNet(num_input_features=5, batch_size=1, grid_shape=GRID,
                      capacities=det_capacities(4096, 1), return_bev=True)
    return jax.jit(lambda v, *a: model.apply(v, *a, False))


def _check_against_jax(tree, result, args, jfwd):
    """The tool's first stage against JAX on each frame's batch, and its
    refined scores and boxes against the JAX refinement on the proposals
    the tool's NMS kept (and its records equal to those steps)."""
    run = det_test.DetTest(args, "cpu")
    ds = det_test.make_dataset(args)
    variables = translate_voxelnet({k: v.numpy().copy() for k, v in
                                    run.model.state_dict().items()})
    rvars = to_jax_two_stage(run.refine.state_dict())
    cfg = run.cfg
    jref = J.TwoStageRefinement(
        bev_channels=512, pc_start=tuple(cfg["pc_range"][:2]),
        voxel_size=tuple(cfg["voxel_size"][:2]),
        out_stride=cfg["out_size_factor"])
    refined = 0
    for i, rec in enumerate(result["samples"]):
        batch = run.batch(ds[i])
        outs, bev = run.forward(batch)
        with torch.no_grad():
            preds, _ = run.model(*tdp.det_inputs(batch, "cpu"))
        jpreds, jbev = jfwd(variables, batch["voxels"], batch["coords"],
                            batch["num_points"], batch["nnz"])
        assert _rel(bev.numpy(), jbev) < MAP_TOL
        for g, w in zip(preds, jpreds):
            for k in w:
                assert _rel(g[k].numpy(), w[k]) < MAP_TOL, k
        det = host_nms(masked_rows(outs), cfg)
        pb, ps = det["box3d_lidar"], det["scores"]
        if not len(pb):
            continue
        n = det_test.N_ROI
        rois = np.zeros((n, 9), np.float32)
        sc = np.zeros(n, np.float32)
        k = min(len(pb), n)
        rois[:k] = T.reorder_to_roi_layout(pb[:k])
        sc[:k] = ps[:k]
        iou, reg = jref.apply(rvars, jnp.transpose(jnp.asarray(
            bev[0].numpy()), (1, 2, 0)), jnp.asarray(rois), jnp.asarray(sc),
            False)
        want_s = np.asarray(J.second_stage_score(iou, jnp.asarray(sc)))[:k]
        want_b = J.roi_layout_to_det3d(np.asarray(J.generate_refined_boxes(
            jnp.asarray(rois), reg)))[:k]
        np.testing.assert_allclose(rec["pred_scores"], want_s, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(rec["pred_boxes"], want_b, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(rec["pred_labels"],
                                      det["label_preds"][:k])
        refined += k
    assert refined > 0
    assert len(result["refine_ms"]) == len(result["samples"])


def test_det_test_two_stage_matches_jax(tree, tiny, jax_first_stage):
    flags = ["--info-path", tree[1]["val"], "--root-path", tree[0],
             "--device", "cpu", "--two-stage"]
    r = det_test.evaluate(det_test.parse_args(flags))
    assert len(r["samples"]) == 2
    assert all(np.isfinite(s["pred_boxes"]).all() for s in r["samples"])
    _check_against_jax(tree, r, det_test.parse_args(flags), jax_first_stage)


def test_det_train_two_stage_then_det_test_reads_its_checkpoint(
        tree, tiny_two_stage, tmp_path, jax_first_stage):
    run_dir = tmp_path / "ts"
    assert det_train_two_stage.main(
        ["--synthetic", "--gt-proposals", "--steps", "3", "--epochs", "1",
         "--run-dir", str(run_dir), "--device", "cpu"]) == 0
    ckpt = torch.load(run_dir / "roi_head.pt", weights_only=True)
    assert ckpt["step"] == 3
    fresh = T.TwoStageRefinement(bev_channels=512, device="cpu",
                                 generator=torch.Generator().manual_seed(1))
    trained = ckpt["roi_head"]
    assert sorted(trained) == sorted(fresh.state_dict())
    assert not torch.equal(trained["roi_head.reg_layers.7.weight"],
                           fresh.state_dict()["roi_head.reg_layers.7.weight"])
    flags = ["--info-path", tree[1]["val"], "--root-path", tree[0],
             "--device", "cpu", "--two-stage-checkpoint",
             str(run_dir / "roi_head.pt")]
    r = det_test.evaluate(det_test.parse_args(flags))
    args = det_test.parse_args(flags)
    run = det_test.DetTest(args, "cpu")
    assert run.two_stage
    for k, v in run.refine.state_dict().items():
        torch.testing.assert_close(v, trained[k], rtol=0, atol=0)
    _check_against_jax(tree, r, args, jax_first_stage)
