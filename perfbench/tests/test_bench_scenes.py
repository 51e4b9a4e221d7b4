"""The ray-cast traffic: seeded, distinct across seeds, and inside every
level's capacity of both configurations."""

import json
from pathlib import Path

import numpy as np
import torch

from perfbench.scenes import audit, raycast, voxelize

BENCH = Path(__file__).resolve().parents[1]


def _traffic(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def _small(tr):
    tr = json.loads(json.dumps(tr))
    tr["sensor"].update(beams=8, azimuths=256)
    return tr


def test_same_seed_same_scans_other_seed_other_scans():
    tr = _small(_traffic("semkitti_train"))
    a = raycast.kitti_scan(raycast.item_seed(2**40 + 3, 0), tr, "cpu")
    b = raycast.kitti_scan(raycast.item_seed(2**40 + 3, 0), tr, "cpu")
    c = raycast.kitti_scan(raycast.item_seed(2**40 + 4, 0), tr, "cpu")
    assert np.array_equal(a["points"], b["points"])
    assert np.array_equal(a["labels"], b["labels"])
    assert a["points"].shape != c["points"].shape or not np.array_equal(
        a["points"], c["points"])
    tn = _small(_traffic("nusc_dflip"))
    tn["sweeps"] = 2
    f = raycast.nusc_frame(raycast.item_seed(7, 1), tn, "cpu")
    g = raycast.nusc_frame(raycast.item_seed(7, 1), tn, "cpu")
    h = raycast.nusc_frame(raycast.item_seed(8, 1), tn, "cpu")
    assert np.array_equal(f["points"], g["points"])
    assert np.array_equal(f["gt_boxes"], g["gt_boxes"])
    assert f["points"].shape != h["points"].shape or not np.array_equal(
        f["points"], h["points"])
    # the time lag of each sweep, 5 features a point
    assert f["points"].shape[1] == 5
    lags = np.unique(f["points"][:, 4])
    assert np.allclose(lags, [0.0, 0.05])


def test_full_size_scan_fits_the_seg_capacities():
    tr = _traffic("semkitti_train")
    cfg = json.loads((BENCH / "configs/linkunet_semkitti.json").read_text())
    scan = raycast.kitti_scan(raycast.item_seed(2**33 + 5, 0), tr, "cpu")
    assert 100_000 < len(scan["points"]) < 131_072
    s = voxelize.train_sample(scan, tr["voxel_size_m"], tr["points_per_scan"],
                              np.random.default_rng(1))
    assert len(s["coords"]) <= tr["points_per_scan"]
    coords = torch.as_tensor(np.concatenate(
        [s["coords"], np.zeros((len(s["coords"]), 1), np.int32)], 1))
    rows = audit.seg_rows(coords, cfg["s"])
    caps = cfg["capacities_per_scan"]
    assert all(r <= c for r, c in zip(rows["rows"], caps))
    assert all(a <= c for a, c in zip(rows["aux"][1:], caps[1:]))


def test_full_size_frame_fits_the_det_capacities():
    from perfbench.reference import centerpoint as ref
    tr = _traffic("nusc_dflip")
    cfg = json.loads((BENCH / "configs/centerpoint_elkv3_nusc.json")
                     .read_text())
    fr = raycast.nusc_frame(raycast.item_seed(2**35 + 9, 0), tr, "cpu")
    assert len(fr["points"]) > 200_000 and len(fr["gt_boxes"]) > 10
    c, _ = ref.voxelize(fr["points"], cfg["voxel_size"], cfg["pc_range"],
                        cfg["max_points_in_voxel"], cfg["max_voxels"])
    rows = audit.det_rows(torch.as_tensor(np.concatenate(
        [c, np.zeros((len(c), 1), np.int64)], 1)), cfg["grid"])
    assert rows[0] < cfg["max_voxels"]
    assert all(r <= cap for r, cap in zip(rows, cfg["capacities_per_frame"]))
