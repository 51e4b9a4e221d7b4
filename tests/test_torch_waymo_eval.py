"""Port vs JAX: the toolkit-free Waymo metrics (`link_tpu_torch/eval/
waymo_eval.py`), exactly.

`evaluate_waymo` on randomized multi-sample worlds (tests/
test_waymo_eval_property.py's `make_world`: yaw-0 boxes whose IoUs
straddle the thresholds, L1 / L2 point counts, headings in multiples of pi)
and on rotated boxes of all three classes, equal to the JAX package's; the
literal oracle of that file as a second check; `accumulate_class` at the
threshold and with ignored gts; `write_waymo_submission`'s JSON equal to
JAX's.
"""

import json

import numpy as np
import pytest

from link_tpu.eval import waymo_eval as JE
from link_tpu_torch.eval import waymo_eval as TE
from test_torch_nuscenes_data import assert_same
from test_waymo_eval_property import _oracle_eval, make_world
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KEYS = ("ap_l1", "ap_l2", "aph_l1", "aph_l2")


def _rotated_world(rng, n_samples):
    """Rotated boxes of the three classes: predictions jittered from the
    gts in position, size and heading, plus false positives."""
    samples = []
    for _ in range(n_samples):
        ng = int(rng.integers(0, 8))
        gt = np.zeros((ng, 9))
        gt[:, :2] = rng.uniform(-40, 40, (ng, 2))
        gt[:, 2] = rng.uniform(-1, 1, ng)
        gt[:, 3:6] = rng.uniform(0.6, 4.5, (ng, 3))
        gt[:, 8] = rng.uniform(-np.pi, np.pi, ng)
        cls = rng.integers(1, 4, ng)
        rows, labels = [], []
        for g in range(ng):
            for _ in range(int(rng.integers(0, 3))):
                p = gt[g].copy()
                p[:3] += rng.normal(0, 0.15, 3)
                p[3:6] *= rng.uniform(0.9, 1.1, 3)
                p[8] += rng.normal(0, 0.6)
                rows.append(p)
                labels.append(cls[g] - 1)
        for _ in range(int(rng.integers(0, 3))):
            p = np.zeros(9)
            p[:2] = rng.uniform(-40, 40, 2)
            p[3:6] = rng.uniform(0.6, 4.5, 3)
            p[8] = rng.uniform(-np.pi, np.pi)
            rows.append(p)
            labels.append(int(rng.integers(0, 3)))
        samples.append({
            "token": f"t{len(samples)}", "gt_boxes": gt, "gt_classes": cls,
            "gt_num_pts": rng.choice([2, 5, 6, 80], ng),
            "pred_boxes": np.asarray(rows).reshape(-1, 9),
            "pred_labels": np.asarray(labels, int),
            "pred_scores": rng.permutation(len(rows)) / (len(rows) + 1.0)
            + 0.01})
    return samples


def _same_metrics(got, want, where):
    assert sorted(got) == sorted(want)
    for k in KEYS:
        for cls in JE.WAYMO_CLASSES:
            g, w = got[k][cls], want[k][cls]
            assert (np.isnan(g) and np.isnan(w)) or g == w, (where, k, cls)
        assert got["m" + k] == want["m" + k], (where, k)


@pytest.mark.parametrize("seed", [23, 24, 25])
def test_evaluate_waymo_matches_jax_and_the_oracle(seed):
    rng = np.random.default_rng(seed)
    for world in range(12):
        samples = make_world(rng, int(rng.integers(1, 4)))
        got = TE.evaluate_waymo(samples)
        _same_metrics(got, JE.evaluate_waymo(samples), world)
        want = _oracle_eval(samples)
        for k in KEYS:
            for cls in TE.WAYMO_CLASSES:
                if np.isnan(want[k][cls]):
                    assert np.isnan(got[k][cls])
                else:
                    np.testing.assert_allclose(got[k][cls], want[k][cls],
                                               atol=1e-9)


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_waymo_on_rotated_boxes_matches_jax(seed):
    rng = np.random.default_rng(seed)
    samples = _rotated_world(rng, 6)
    got = TE.evaluate_waymo(samples)
    _same_metrics(got, JE.evaluate_waymo(samples), seed)
    assert np.isfinite(got["map_l2"]) and got["map_l2"] > 0


def test_accumulate_class_edges_match_jax():
    gt = [np.array([[0, 0, 0, 3.0, 2, 2, 0.0]])]
    preds = [np.array([[1.0, 0, 0, 3.0, 2, 2, 0.0]])]
    for th in (0.5, 0.5 + 1e-6):
        assert TE.accumulate_class(gt, preds, [np.array([0.9])], th) == \
            JE.accumulate_class(gt, preds, [np.array([0.9])], th)
    gt = [np.array([[0, 0, 0, 2, 2, 2, 0.0], [10, 0, 0, 2, 2, 2, 0.0]])]
    preds = [np.array([[0, 0, 0, 2, 2, 2, 0.0],
                       [10, 0, 0, 2, 2, 2, np.pi]])]
    for keep in ([np.array([False, True])], [np.array([False, False])]):
        got = TE.accumulate_class(gt, preds, [np.array([0.9, 0.8])], 0.7,
                                  gt_keep=keep)
        want = JE.accumulate_class(gt, preds, [np.array([0.9, 0.8])], 0.7,
                                   gt_keep=keep)
        assert_same(got, want)


def test_write_waymo_submission_matches_jax(tmp_path):
    samples = _rotated_world(np.random.default_rng(3), 3)
    got = TE.write_waymo_submission(samples, str(tmp_path / "port.bin"))
    want = JE.write_waymo_submission(samples, str(tmp_path / "jax.bin"))
    assert got.endswith(".json") and want.endswith(".json")
    with open(got) as f, open(want) as g:
        a, b = json.load(f), json.load(g)
    assert a == b and len(a) == sum(len(s["pred_scores"]) for s in samples)
