"""Waymo Open Dataset detection data: the frame reader with its sweeps, the
dataset, and synthetic frames in the decoded layout.

A copy of `link_tpu/data/waymo.py` (reference detection/det3d/datasets/
waymo/waymo.py + waymo_common.py, pipelines/loading.py:71-101), kept here
so the port imports nothing of the JAX package. Same semantics and the same
random stream per seed. The reference consumes the TFRecord-derived
pickles of its converter (tools/create_data_waymo decode, which needs the
`waymo-open-dataset` toolkit):

Frame pickle schema (waymo_decoder.py):
  {'scene_name', 'frame_name' ('<scene>_<micros>_<micros>'), 'frame_id',
   'veh_to_global' (16,), 'lidars': {'points_xyz': (N, 3),
   'points_feature': (N, 2) (intensity, elongation)}}
Annos pickle: the same identity fields and 'objects': [{'id', 'name',
  'label' (1 VEHICLE, 2 PEDESTRIAN, 4 CYCLIST), 'box' raw 9-dof [x y z l w
  h vx vy heading] (velocity in the vehicle frame), 'num_points'}].
Info pickle (tools/create_data_waymo infos): list of {'path', 'anno_path',
  'token', 'timestamp', 'sweeps': [{'path', 'token', 'transform_matrix',
  'time_lag'}], 'veh_to_global', 'gt_boxes' (det3d [x y z w l h vx vy r]),
  'gt_names', 'gt_num_pts'}.

`write_synthetic_tree` writes made frames in the decoded layout, for runs
without the dataset.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np

from . import det_pipeline as dp

WAYMO_CLASSES = ("VEHICLE", "PEDESTRIAN", "CYCLIST")
WAYMO_TASKS = (("VEHICLE",), ("PEDESTRIAN",), ("CYCLIST",))


def read_frame(path: str) -> Dict:
    """Lidar frame pickle -> (N, 5) points [x y z intensity elongation],
    intensity tanh-normalized (reference loading.py:71-80
    read_single_waymo). GT lives in the info pkls (det3d convention,
    converted at info time by tools/create_data_waymo, mirroring
    waymo_common.py:260-276)."""
    with open(path, "rb") as f:
        frame = pickle.load(f)
    feat = frame["lidars"]["points_feature"].astype(np.float32).copy()
    feat[:, 0] = np.tanh(feat[:, 0])   # intensity normalization
    pts = np.concatenate(
        [frame["lidars"]["points_xyz"].astype(np.float32), feat], axis=1)
    return {"points": pts}


def load_waymo_sweeps(info: Dict, root_path: str, nsweeps: int) -> Dict:
    """Multi-sweep accumulation with a time-lag channel (reference
    pipelines/loading.py:71-101 read_single_waymo[_sweep]): sweeps are
    re-projected into the keyframe vehicle frame via the stored
    transform_matrix; points become (N, 6) = (x y z intensity elongation
    time)."""
    frame = read_frame(os.path.join(root_path, info["path"]))
    points = frame["points"]
    pts_list = [points]
    times = [np.zeros((len(points), 1), np.float32)]
    for sweep in info.get("sweeps", [])[:max(0, nsweeps - 1)]:
        with open(os.path.join(root_path, sweep["path"]), "rb") as f:
            obj = pickle.load(f)
        feat = obj["lidars"]["points_feature"].astype(np.float32).copy()
        feat[:, 0] = np.tanh(feat[:, 0])
        ps = np.concatenate(
            [obj["lidars"]["points_xyz"].astype(np.float32), feat], axis=1)
        tm = sweep.get("transform_matrix")
        if tm is not None:
            xyz1 = np.concatenate(
                [ps[:, :3], np.ones((len(ps), 1), np.float32)], axis=1)
            ps[:, :3] = (xyz1 @ np.asarray(tm, np.float32).T)[:, :3]
        pts_list.append(ps)
        times.append(np.full((len(ps), 1), sweep["time_lag"], np.float32))
    if nsweeps > 1:
        frame["points"] = np.concatenate(
            [np.concatenate(pts_list), np.concatenate(times)], axis=1)
    return frame


class WaymoDataset:
    """The frames of an info pkl. Val mode passes the unaugmented GT of the
    three classes through (with `gt_num_pts`, for eval/waymo_eval); train
    mode pastes GT-AUG samples (`db_sampler`), augments
    (`det_pipeline.global_augment`), shuffles the points and draws the
    CenterNet targets of the three single-class tasks, every draw from one
    generator of `seed` in the JAX package's order."""

    def __init__(self, info_path: str, root_path: str = "",
                 mode: str = "train", nsweeps: int = 1,
                 class_names=WAYMO_CLASSES,
                 pc_range=(-75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
                 voxel_size=(0.1, 0.1, 0.15), max_points_in_voxel=5,
                 max_voxels=(150000, 200000), out_size_factor=8,
                 db_sampler=None, seed: int = 0):
        with open(info_path, "rb") as f:
            self.infos = pickle.load(f)
        self.root_path = root_path
        self.nsweeps = nsweeps
        self.mode = mode
        self.class_names = list(class_names)
        self.pc_range = pc_range
        self.voxel_size = voxel_size
        self.max_points_in_voxel = max_points_in_voxel
        self.max_voxels = max_voxels[0] if mode == "train" else max_voxels[1]
        self.out_size_factor = out_size_factor
        self.db_sampler = db_sampler
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, index: int) -> Dict:
        info = self.infos[index]
        frame = load_waymo_sweeps(info, self.root_path, self.nsweeps)
        points = frame["points"]
        sample = {"token": info.get("token", str(index))}

        gt_boxes = np.asarray(info.get("gt_boxes",
                                       np.zeros((0, 9))), np.float32)
        gt_names = np.asarray(info.get("gt_names", [])).reshape(-1)

        if self.mode != "train":
            # unaugmented GT passthrough for eval/waymo_eval.py
            keep = np.isin(gt_names, self.class_names)
            sample["gt_boxes"] = gt_boxes[keep]
            sample["gt_classes"] = np.array(
                [self.class_names.index(n) + 1
                 for n in gt_names[keep]], np.int32)
            if "gt_num_pts" in info:
                sample["gt_num_pts"] = np.asarray(
                    info["gt_num_pts"])[keep]

        if self.mode == "train":
            boxes, names = gt_boxes, gt_names
            keep = np.isin(names, self.class_names)
            boxes, names = boxes[keep], names[keep]
            if self.db_sampler is not None:
                sampled = self.db_sampler.sample_all(boxes, names, self.rng)
                if sampled is not None:
                    names = np.concatenate([names, sampled["gt_names"]])
                    boxes = np.concatenate([boxes, sampled["gt_boxes"]])
                    points = np.concatenate([sampled["points"], points])
            classes = np.array(
                [self.class_names.index(n) + 1 for n in names], np.int32)
            points, boxes = dp.global_augment(points, boxes, self.rng)
            self.rng.shuffle(points)
            sample["targets"] = dp.assign_label(
                boxes, classes, tasks=WAYMO_TASKS,
                class_names=self.class_names, pc_range=self.pc_range,
                voxel_size=self.voxel_size,
                out_size_factor=self.out_size_factor)
            sample["gt_boxes"] = boxes
            sample["gt_classes"] = classes

        voxels, coords_zyx, nppv = dp.points_to_voxel(
            points, self.voxel_size, self.pc_range,
            self.max_points_in_voxel, self.max_voxels)
        sample.update({"voxels": voxels, "coords_zyx": coords_zyx,
                       "num_points": nppv})
        return sample


# ---------------------------------------------------------------------------
# synthetic frames in the decoded layout

# the top lidar (the Waymo vehicle's): 64 beams from -17.6 to +2.4 degrees,
# 2.18 m above the ground, 1.43 m ahead of the vehicle frame's origin
LIDAR_ORIGIN = (1.43, 0.0, 2.18)
LIDAR_BEAMS = 64
LIDAR_ELEVATION_DEG = (-17.6, 2.4)
LIDAR_RANGE = 75.0
FRAME_DT_US = 100000             # 10 Hz
# label -> (name, physical l w h) of the three classes
OBJECT_KINDS = {1: ("VEHICLE", (4.6, 2.0, 1.6)),
                2: ("PEDESTRIAN", (0.7, 0.7, 1.75)),
                4: ("CYCLIST", (1.8, 0.7, 1.7))}
LABEL_MARGIN = 0.2               # labelled boxes enclose the surfaces
TREE_HIT = 0.9


def _pose(yaw: float, tx: float, ty: float) -> np.ndarray:
    m = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    m[:2, :2] = [[c, -s], [s, c]]
    m[:3, 3] = [tx, ty, 0.0]
    return m


def _world(rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """One sequence's street in the global frame, along +x: building
    facades on both sides (vertical segments, x0 x1 y height), parked and
    moving vehicles, pedestrians on the sidewalks and cyclists near the
    kerb (centre x y, heading, velocity vx vy, label), and street trees."""
    walls = []
    for side in (-1, 1):
        x = -120.0
        while x < 220.0:
            length = rng.uniform(15, 40)
            walls.append((x, x + length, side * rng.uniform(13, 18),
                          rng.uniform(5, 15)))
            x += length + rng.uniform(4, 15)
    objs = []

    def add(n, label, y_lo, y_hi, speed):
        for _ in range(n):
            side = rng.choice((-1.0, 1.0))
            heading = 0.0 if side > 0 else np.pi
            heading += rng.normal(0, 0.05)
            v = rng.uniform(*speed) if rng.random() < 0.7 else 0.0
            objs.append((rng.uniform(-100, 200), side * rng.uniform(y_lo, y_hi),
                         heading, v * np.cos(heading), v * np.sin(heading),
                         label))

    add(36, 1, 1.5, 9.0, (4.0, 14.0))
    add(24, 2, 9.5, 12.0, (0.5, 1.8))
    add(8, 4, 7.0, 9.0, (3.0, 6.0))
    # street trees along both kerbs: canopy spheres (x y z radius)
    # and hedges (spheres low on the ground)
    n_tree, n_hedge = 120, 160
    trees = np.concatenate([np.stack([
        rng.uniform(-120, 220, n_tree),
        rng.choice((-1.0, 1.0), n_tree) * rng.uniform(10.5, 12.5, n_tree),
        rng.uniform(2.6, 3.4, n_tree), rng.uniform(1.5, 2.8, n_tree)], 1),
        np.stack([rng.uniform(-120, 220, n_hedge),
                  rng.choice((-1.0, 1.0), n_hedge)
                  * rng.uniform(12.0, 13.0, n_hedge),
                  np.full(n_hedge, 0.3), rng.uniform(0.8, 1.3, n_hedge)],
                 1)])
    return {"walls": np.asarray(walls, np.float64),
            "objects": np.asarray(objs, np.float64), "trees": trees}


def _columns(az, origin, xy=None, circle=None):
    """Indices of the sorted azimuths `az` (in [-pi, pi)) within the
    smallest arc, seen from `origin`, that holds the points `xy` (K, 2) or
    the disc `circle` (x, y, radius); every index when that arc is not
    less than a half turn (the origin inside)."""
    if circle is not None:
        dx, dy = circle[0] - origin[0], circle[1] - origin[1]
        d = np.hypot(dx, dy)
        if d <= circle[2]:
            return np.arange(len(az))
        c, half = np.arctan2(dy, dx), np.arcsin(circle[2] / d)
        start, end = c - half, c + half
    else:
        ang = np.sort(np.arctan2(xy[:, 1] - origin[1], xy[:, 0] - origin[0]))
        gaps = np.diff(np.r_[ang, ang[0] + 2 * np.pi])
        k = int(np.argmax(gaps))
        if gaps[k] <= np.pi:
            return np.arange(len(az))
        start = ang[(k + 1) % len(ang)]
        end = ang[k] + (2 * np.pi if k + 1 < len(ang) else 0.0)
    start = (start + np.pi) % (2 * np.pi) - np.pi
    width = (end - start) % (2 * np.pi)
    i0 = np.searchsorted(az, start)
    i1 = np.searchsorted(az, start + width, side="right")
    if start + width < np.pi:
        return np.arange(i0, i1)
    i2 = np.searchsorted(az, start + width - 2 * np.pi, side="right")
    return np.r_[np.arange(i0, len(az)), np.arange(0, i2)]


def _cast(origin, elev, az, walls, boxes, trees, rng):
    """Ray distances (E, A) (inf where nothing is hit) of the beams at
    elevations `elev` (E,) and sorted azimuths `az` (A,) from `origin`, in
    the vehicle frame: the ground z = 0, the facades (x0, y0, x1, y1,
    height), the objects' boxes (x y z l w h heading, z the centre), and
    the tree canopies (x y z radius), which a ray enters with a chance of
    TREE_HIT and then stops at a random depth (foliage scatters its
    returns through the canopy's volume). Each primitive is tested against
    the azimuths it spans only."""
    o = np.asarray(origin, np.float64)
    e, a = np.meshgrid(elev, az, indexing="ij")
    dirs = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a),
                     np.sin(e)], -1)                       # (E, A, 3)
    t = np.full(e.shape, np.inf)
    down = dirs[..., 2] < -1e-9
    t[down] = -o[2] / dirs[..., 2][down]
    for x0, y0, x1, y1, height in walls:
        cols = _columns(az, o, xy=np.array([[x0, y0], [x1, y1]]))
        d = dirs[:, cols]
        ex, ey = x1 - x0, y1 - y0
        # o + t d = p0 + u e in the x-y plane
        den = d[..., 0] * ey - d[..., 1] * ex
        wx, wy = x0 - o[0], y0 - o[1]
        with np.errstate(divide="ignore", invalid="ignore"):
            tt = (wx * ey - wy * ex) / den
            u = (wx * d[..., 1] - wy * d[..., 0]) / den
        z = o[2] + tt * d[..., 2]
        hit = ((np.abs(den) > 1e-12) & (tt > 0) & (u >= 0) & (u <= 1)
               & (z >= 0) & (z <= height))
        t[:, cols] = np.where(hit & (tt < t[:, cols]), tt, t[:, cols])
    for x, y, z, l, w, h, heading in boxes:
        c, s = np.cos(heading), np.sin(heading)
        corners = np.array([[x + c * u * l / 2 - s * v * w / 2,
                             y + s * u * l / 2 + c * v * w / 2]
                            for u in (-1, 1) for v in (-1, 1)])
        cols = _columns(az, o, xy=corners)
        d = dirs[:, cols]
        rel = o - (x, y, z)
        lo = np.array([c * rel[0] + s * rel[1], -s * rel[0] + c * rel[1],
                       rel[2]])
        ld = np.stack([c * d[..., 0] + s * d[..., 1],
                       -s * d[..., 0] + c * d[..., 1], d[..., 2]], -1)
        half = np.array([l, w, h]) / 2
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (-half - lo) / ld
            t2 = (half - lo) / ld
        tmin = np.nanmax(np.minimum(t1, t2), -1)
        tmax = np.nanmin(np.maximum(t1, t2), -1)
        hit = (tmax >= tmin) & (tmin > 0)
        t[:, cols] = np.where(hit & (tmin < t[:, cols]), tmin, t[:, cols])
    for x, y, z, r in trees:
        cols = _columns(az, o, circle=(x, y, r))
        d = dirs[:, cols]
        rel = o - (x, y, z)
        b = d @ rel
        disc = b * b - (rel @ rel - r * r)
        near = disc > 0
        root = np.sqrt(np.where(near, disc, 0.0))
        t0, t1 = -b - root, -b + root
        stop = near & (t0 > 0) & (rng.random(near.shape) < TREE_HIT)
        tt = t0 + (t1 - t0) * rng.random(near.shape)
        t[:, cols] = np.where(stop & (tt < t[:, cols]), tt, t[:, cols])
    return t, dirs


def synthetic_frame(world: Dict[str, np.ndarray], pose: np.ndarray,
                    t_s: float, n_points: int, rng: np.random.Generator):
    """One frame of `world` seen from the vehicle at `pose` at time `t_s`:
    the top lidar's first returns (64 beams, the azimuths spaced to give
    about `n_points` returns), second returns on a random tenth of them,
    the cloud cut to `n_points` points of the detection range; and the raw
    boxes of the objects, velocities in the vehicle frame, with their
    point counts. Returns (xyz (n, 3), features (n, 2), objects)."""
    inv = np.linalg.inv(pose)
    rot_inv = inv[:3, :3]
    walls = []
    for x0, x1, y, height in world["walls"]:
        a = inv @ (x0, y, 0.0, 1.0)
        b = inv @ (x1, y, 0.0, 1.0)
        walls.append((a[0], a[1], b[0], b[1], height))
    boxes, objs = [], []
    for x, y, heading, vx, vy, label in world["objects"]:
        name, (l, w, h) = OBJECT_KINDS[int(label)]
        g = np.array([x + vx * t_s, y + vy * t_s, h / 2, 1.0])
        p = inv @ g
        yaw = heading - np.arctan2(pose[1, 0], pose[0, 0])
        if np.hypot(p[0], p[1]) > LIDAR_RANGE + 5:
            continue
        boxes.append((p[0], p[1], p[2], l, w, h, yaw))
        vel = rot_inv @ np.array([vx, vy, 0.0])
        objs.append((name, int(label), p[:3], (l, w, h), vel[:2], yaw))
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
    trees = [(*(inv @ (x, y, z, 1.0))[:3], r)
             for x, y, z, r in world["trees"]]

    lo, hi = np.deg2rad(LIDAR_ELEVATION_DEG)
    # the beams crowd towards the horizon, as the top lidar's do
    elev = hi - (hi - lo) * np.linspace(0, 1, LIDAR_BEAMS) ** 2
    n_az = int(np.ceil(1.5 * n_points / LIDAR_BEAMS))
    az = np.linspace(-np.pi, np.pi, n_az, endpoint=False)
    az = az + rng.uniform(0, 2 * np.pi / n_az)
    t, dirs = _cast(LIDAR_ORIGIN, elev,
                    np.sort((az + np.pi) % (2 * np.pi) - np.pi),
                    walls, boxes, trees, rng)
    t, dirs = t.reshape(-1), dirs.reshape(-1, 3)
    hit = np.isfinite(t) & (t < LIDAR_RANGE)
    t = t[hit] + rng.normal(0, 0.02, int(hit.sum()))
    xyz = np.asarray(LIDAR_ORIGIN) + dirs[hit] * t[:, None]
    second = rng.random(len(xyz)) < 0.1
    xyz = np.concatenate([xyz, xyz[second] + rng.normal(0, 0.05, (
        int(second.sum()), 3))])
    inside = ((np.abs(xyz[:, :2]) < 75.2).all(1) & (xyz[:, 2] > -2.0)
              & (xyz[:, 2] < 4.0))
    xyz = xyz[inside]
    if len(xyz) > n_points:
        xyz = xyz[np.sort(rng.choice(len(xyz), n_points, replace=False))]
    feat = np.stack([rng.gamma(2.0, 0.15, len(xyz)),
                     rng.uniform(0, 0.3, len(xyz))], 1)

    objects = []
    for k, (name, label, c, (l, w, h), vel, yaw) in enumerate(objs):
        L, W, H = l + LABEL_MARGIN, w + LABEL_MARGIN, h + LABEL_MARGIN
        d = xyz - c
        cs, sn = np.cos(yaw), np.sin(yaw)
        u = cs * d[:, 0] + sn * d[:, 1]
        v = -sn * d[:, 0] + cs * d[:, 1]
        n_in = int(((np.abs(u) <= L / 2) & (np.abs(v) <= W / 2)
                    & (np.abs(d[:, 2]) <= H / 2)).sum())
        objects.append({"id": f"{name.lower()}_{k}", "name": f"{name}_{k}",
                        "label": label,
                        "box": np.array([c[0], c[1], c[2], L, W, H, vel[0],
                                         vel[1], yaw], np.float32),
                        "num_points": n_in})
    return xyz.astype(np.float32), feat.astype(np.float32), objects


def write_synthetic_tree(root: str, n_frames: int,
                         points_per_frame: int = 180000, seed: int = 0,
                         split: str = "train",
                         sequences: int = 2) -> List[str]:
    """Write synthetic frames in the decoded layout under `root`, for runs
    without the dataset: `<root>/<split>/lidar/seq_<s>_frame_<f>.pkl` and
    `<root>/<split>/annos/seq_<s>_frame_<f>.pkl` in the schema of
    tools/create_data_waymo decode, `n_frames` frames in each of
    `sequences` sequences. Sequence s is a street made from seed + s
    (`_world`: facades, vehicles, pedestrians, cyclists) driven along at
    10 m/s while turning 0.02 rad a frame, at 10 Hz; each frame is the top
    lidar's scan of it (`synthetic_frame`: `points_per_frame` points over
    the +-75.2 m detection range, the ground, facades and objects hit by
    64 beams) with its vehicle pose, and the objects' raw boxes (velocity
    in the vehicle frame, `num_points` the frame's points in the box;
    objects out of sight have 0, and the info step drops them). Returns
    the frame pickles' paths."""
    lidar_dir = os.path.join(root, split, "lidar")
    anno_dir = os.path.join(root, split, "annos")
    os.makedirs(lidar_dir, exist_ok=True)
    os.makedirs(anno_dir, exist_ok=True)
    paths = []
    for seq in range(sequences):
        rng = np.random.default_rng(seed + seq)
        world = _world(rng)
        scene = f"synthetic_{seed}_{seq}"
        for fid in range(n_frames):
            t_s = 0.1 * fid
            pose = _pose(0.02 * fid, 10.0 * t_s, 0.0)
            xyz, feat, objects = synthetic_frame(world, pose, t_s,
                                                 points_per_frame, rng)
            ts = 1_500_000_000_000_000 + 10_000_000 * seq + FRAME_DT_US * fid
            ident = {"scene_name": scene,
                     "frame_name": f"{scene}_{ts}_{ts}", "frame_id": fid,
                     "veh_to_global": pose.reshape(-1)}
            name = f"seq_{seq}_frame_{fid}.pkl"
            path = os.path.join(lidar_dir, name)
            with open(path, "wb") as f:
                pickle.dump({**ident, "lidars": {"points_xyz": xyz,
                                                 "points_feature": feat}}, f)
            with open(os.path.join(anno_dir, name), "wb") as f:
                pickle.dump({**ident, "objects": objects}, f)
            paths.append(path)
    return paths
