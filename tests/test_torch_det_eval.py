"""Port vs JAX: the detection evaluation (`link_tpu_torch/eval/`) and the
double-flip decode (`models/center_head.double_flip_fuse`,
`decode_boxes(double_flip=True)`).

The eval modules are NumPy copies: `evaluate_nuscenes`, `group_by_class`
(without and with `infos`, the boxes then moved to the global frame),
`write_submission`, `fuse_sample` and `rotate_predictions_back` give the
JAX package's numbers exactly (rtol 0) on tests/test_eval.py's inputs and
on perfect and noisy predictions. The double-flip fuse and decode hold the
reference's golden (tests/goldens/det_flip.npz, the bounds of
tests/test_golden_det_dense.py: boxes rtol 1e-4 / atol 1e-5, scores rtol
1e-5, labels exact) and JAX's decode on random maps (float32, 1e-6).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from link_tpu.eval import nuscenes_eval as JNE
from link_tpu.eval import submission as jsub
from link_tpu.eval import tta_fusion as jtta
from link_tpu.models.center_head import decode_boxes as j_decode
from link_tpu.models.center_head import double_flip_fuse as j_fuse
from link_tpu_torch.data.det_pipeline import NUSC_CLASSES
from link_tpu_torch.eval import nuscenes_eval as TNE
from link_tpu_torch.eval import submission as tsub
from link_tpu_torch.eval import tta_fusion as ttta
from link_tpu_torch.models.center_head import decode_boxes as t_decode
from link_tpu_torch.models.center_head import double_flip_fuse as t_fuse
from test_torch_nuscenes_data import assert_same
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FLIP_GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                           "det_flip.npz")
FLIP_CFG = dict(post_center_limit_range=[-8.0, -8.0, -10.0, 8.0, 8.0, 10.0],
                score_threshold=0.4, pc_range=[-6.0, -6.0],
                voxel_size=[0.075, 0.075], out_size_factor=8)
NUM_CLASSES = [1, 2, 2, 1, 2, 2]
HEADS = ("hm", "reg", "height", "dim", "rot", "vel")


def _boxes(rng, n):
    """tests/test_eval.py's boxes: centres within +-20 m."""
    b = np.zeros((n, 9), np.float32)
    b[:, :2] = rng.uniform(-20, 20, (n, 2))
    b[:, 2] = rng.uniform(-2, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 4, (n, 3))
    b[:, 6:8] = rng.normal(0, 1, (n, 2))
    b[:, 8] = rng.uniform(-np.pi, np.pi, n)
    return b


def _samples(seed, kind):
    """tests/test_eval.py's perfect and noisy predictions, 4 frames of 12
    boxes; "far" adds boxes beyond every class range and zero-point GT."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(4):
        gt = _boxes(rng, 12)
        cls = rng.integers(1, 11, 12)
        attrs = np.asarray([JNE._attr_for(NUSC_CLASSES[c - 1], b[6:8])
                            if i % 2 else "" for c, b in zip(cls, gt)],
                           object)
        pred = gt.copy()
        scores = np.linspace(0.9, 0.5, 12)
        if kind != "perfect":
            pred[:, :2] += rng.normal(0, 1.5, (12, 2))
            pred[:6, :2] += 100
            scores = rng.uniform(0.3, 0.9, 12)
        s = {"token": f"tok{i}", "gt_boxes": gt, "gt_classes": cls,
             "pred_boxes": pred, "pred_scores": scores,
             "pred_labels": cls - 1, "gt_attributes": attrs}
        if kind == "far":
            s["gt_boxes"][:2, :2] += 45
            s["gt_num_pts"] = np.r_[np.zeros(2, int), np.ones(10, int)]
        out.append(s)
    return out


def _infos(samples, seed):
    """A lidar -> global chain per token (rotation about z, translation)."""
    rng = np.random.default_rng(seed)
    out = {}
    for s in samples:
        th, th2 = rng.uniform(-np.pi, np.pi, 2)
        ref_from_car = np.eye(4)
        ref_from_car[:3, :3] = [[np.cos(th2), -np.sin(th2), 0],
                                [np.sin(th2), np.cos(th2), 0], [0, 0, 1]]
        ref_from_car[:3, 3] = rng.normal(0, 1, 3)
        car_from_global = np.eye(4)
        car_from_global[:3, :3] = [[np.cos(th), -np.sin(th), 0],
                                   [np.sin(th), np.cos(th), 0], [0, 0, 1]]
        car_from_global[:3, 3] = rng.uniform(-500, 500, 3)
        out[s["token"]] = {"ref_from_car": ref_from_car,
                           "car_from_global": car_from_global}
    return out


@pytest.mark.parametrize("kind", ["perfect", "noisy", "far"])
@pytest.mark.parametrize("with_infos", [False, True])
def test_evaluate_nuscenes_matches_jax(kind, with_infos):
    samples = _samples(90 + len(kind), kind)
    infos = _infos(samples, 7) if with_infos else None
    got = TNE.group_by_class(samples, infos=infos)
    want = JNE.group_by_class(samples, infos=infos)
    assert_same([dict(g) for g in got], [dict(w) for w in want])
    m_got = TNE.evaluate_nuscenes(*got[:3], attrs_by_class=got[3])
    m_want = JNE.evaluate_nuscenes(*want[:3], attrs_by_class=want[3])
    assert_same(m_got, m_want, "metrics")
    if kind == "perfect":
        assert m_got["mean_ap"] > 0.95


@pytest.mark.parametrize("with_infos", [False, True])
def test_write_submission_matches_jax(tmp_path, with_infos):
    samples = _samples(92, "noisy")
    infos = _infos(samples, 8) if with_infos else None
    got = tsub.write_submission(samples, str(tmp_path / "t.json"), infos)
    want = jsub.write_submission(samples, str(tmp_path / "j.json"), infos)
    assert json.load(open(got)) == json.load(open(want))
    assert len(json.load(open(got))["results"]["tok0"]) == 12


def test_global_frame_helpers_match_jax():
    rng = np.random.default_rng(93)
    b = _boxes(rng, 6).astype(np.float64)
    info = _infos([{"token": "t"}], 9)["t"]
    assert_same(tsub.det3d_to_devkit_yaw(b), jsub.det3d_to_devkit_yaw(b))
    assert_same(tsub.boxes_lidar_to_global(b, info),
                jsub.boxes_lidar_to_global(b, info))


@pytest.mark.parametrize("seed", [94, 95])
def test_fuse_sample_matches_jax(seed):
    rng = np.random.default_rng(seed)
    base = _boxes(rng, 10)
    labels = rng.integers(0, 10, 10)
    runs = []
    for _ in range(3):
        jitter = base.copy()
        jitter[:, :2] += rng.normal(0, 0.05, (10, 2))
        runs.append({"boxes": jitter, "scores": rng.uniform(0.5, 1.0, 10),
                     "labels": labels})
    for cap in (500, 7):
        got = ttta.fuse_sample(runs, NUSC_CLASSES, max_boxes=cap)
        assert_same(got, jtta.fuse_sample(runs, NUSC_CLASSES, max_boxes=cap))
        assert len(got["boxes"]) <= min(cap, 14)
    empty = [{"boxes": np.zeros((0, 9)), "scores": np.zeros(0),
              "labels": np.zeros(0, np.int64)}]
    assert_same(ttta.fuse_sample(empty, NUSC_CLASSES),
                jtta.fuse_sample(empty, NUSC_CLASSES))


@pytest.mark.parametrize("deg", [12.5, -25.0])
def test_rotate_predictions_back_matches_jax(deg):
    b = _boxes(np.random.default_rng(96), 5)
    got = ttta.rotate_predictions_back(b, np.deg2rad(deg))
    assert_same(got, jtta.rotate_predictions_back(b, np.deg2rad(deg)))
    assert ttta.TTA_ROT_ANGLES == jtta.TTA_ROT_ANGLES
    assert ttta.NAME_TO_THRESH == jtta.NAME_TO_THRESH


def _rows(outs):
    """Each task's rows above the threshold, by descending score (the
    reference's circle NMS emits them so), concatenated."""
    rows = ([], [], [])
    for bx, sc, lb, mk in outs:
        m = np.asarray(mk[0])
        b, s, lab = (np.asarray(bx[0])[m], np.asarray(sc[0])[m],
                     np.asarray(lb[0])[m])
        order = np.argsort(-s, kind="stable")
        for dst, src in zip(rows, (b, s, lab)):
            dst.append(src[order])
    return tuple(np.concatenate(r) for r in rows)


def test_double_flip_decode_matches_the_golden():
    z = np.load(FLIP_GOLDEN)
    preds = [{k: torch.from_numpy(np.ascontiguousarray(np.transpose(
        z[f"flip_t{t}_{k}"], (0, 2, 3, 1)))) for k in HEADS}
        for t in range(6)]
    boxes, scores, labels = _rows(t_decode(preds, FLIP_CFG, NUM_CLASSES,
                                           double_flip=True))
    assert boxes.shape == z["flip_boxes"].shape
    np.testing.assert_allclose(boxes, z["flip_boxes"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(scores, z["flip_scores"], rtol=1e-5)
    np.testing.assert_array_equal(labels, z["flip_labels"])


def _random_maps(seed, b=4, h=6, w=7, channels=(1, 2)):
    rng = np.random.default_rng(seed)
    widths = dict(reg=2, height=1, dim=3, rot=2, vel=2)
    return [{**{k: rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
                for k, c in widths.items()},
             "hm": rng.normal(-1, 1.5, (b, h, w, nc)).astype(np.float32)}
            for nc in channels]


def test_double_flip_fuse_matches_jax():
    for pd in _random_maps(1, b=8):
        got = t_fuse({k: torch.from_numpy(v) for k, v in pd.items()})
        want = j_fuse({k: jnp.asarray(v) for k, v in pd.items()})
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("double_flip", [False, True])
def test_decode_boxes_matches_jax_on_random_maps(double_flip):
    maps = _random_maps(2)
    cfg = dict(post_center_limit_range=[-5.0, -5.0, -10.0, 5.0, 5.0, 10.0],
               score_threshold=0.3, pc_range=[-4.0, -4.0],
               voxel_size=[0.2, 0.2], out_size_factor=4)
    got = t_decode([{k: torch.from_numpy(v) for k, v in pd.items()}
                    for pd in maps], cfg, [1, 2], double_flip=double_flip)
    want = j_decode([{k: jnp.asarray(v) for k, v in pd.items()}
                     for pd in maps], cfg, [1, 2], double_flip=double_flip)
    for (gb, gs, gl, gm), (wb, ws, wl, wm) in zip(got, want):
        assert gb.shape == wb.shape == (1 if double_flip else 4, 42, 9)
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
