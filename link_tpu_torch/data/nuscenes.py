"""nuScenes detection data: the info-pkl reader with its sweeps and CBGS,
the synthetic source, and synthetic files in the dataset's layout.

A copy of `link_tpu/data/nuscenes.py` (reference detection/det3d/datasets/
nuscenes/nuscenes.py:29-347, pipelines/loading.py:23-183), kept here so the
port imports nothing of the JAX package. Same semantics and the same random
stream per seed:
  * `load_sweeps`: the keyframe's (x, y, z, intensity) and nsweeps - 1 of
    its sweeps, drawn without replacement, each moved into the keyframe's
    lidar frame by its `transform_matrix` (None: already there), the ego
    returns within 1 m removed, and a `time_lag` column;
  * `cbgs_resample`: class-balanced resampling of the infos;
  * `NuScenesDataset`: train mode drops DontCare / ignore boxes, pastes
    GT-AUG samples (`db_sampler`), keeps the ten classes, augments
    (`det_pipeline.global_augment`), shuffles the points and draws the
    CenterNet targets; val mode passes the unaugmented GT through (with
    `gt_attributes` / `gt_num_pts`) and can rotate the input (`tt_rotation`,
    radians) and add the three flipped voxelizations (`double_flip`);
  * `SyntheticNuScenes`: a 200k-point frame over the 54 m disc of the
    detection range, at the published 0.075 x 0.075 x 0.2 m grid; in train
    mode with 5-39 random boxes of the ten classes and their targets.

Info pickle format (one dict per keyframe; tools/create_data.py):
  lidar_path, token, sweeps [{lidar_path, transform_matrix, time_lag}],
  ref_from_car, car_from_global, timestamp, gt_boxes (N, 9)
  [x y z w l h vx vy rot], gt_names, gt_boxes_velocity, gt_attributes,
  gt_num_pts.

`write_synthetic_infos` writes synthetic frames in that format, for runs
without the dataset.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from . import det_pipeline as dp
from .det_pipeline import NUSC_CLASSES

GENERAL_TO_DETECTION = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.wheelchair": "ignore",
    "human.pedestrian.stroller": "ignore",
    "human.pedestrian.personal_mobility": "ignore",
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "animal": "ignore",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.emergency.ambulance": "ignore",
    "vehicle.emergency.police": "ignore",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.pushable_pullable": "ignore",
    "movable_object.debris": "ignore",
    "static_object.bicycle_rack": "ignore",
}


def read_file(path: str) -> np.ndarray:
    """Raw nuScenes .bin: (N, 5) float32, keep (x, y, z, intensity)
    (loading.py:23-37)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 5)[:, :4]


def remove_close(points: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """Drop ego-vehicle returns (loading.py:66-74)."""
    keep = ~((np.abs(points[:, 0]) < radius) & (np.abs(points[:, 1]) < radius))
    return points[keep]


def read_sweep(sweep: Dict):
    """One sweep moved into the keyframe's frame (loading.py:77-90):
    points (N, 4) and their time lags (N, 1)."""
    points_sweep = read_file(str(sweep["lidar_path"])).T  # (4, N)
    nbr = points_sweep.shape[1]
    if sweep["transform_matrix"] is not None:
        tm = sweep["transform_matrix"]
        points_sweep[:3, :] = tm.dot(
            np.vstack((points_sweep[:3, :], np.ones(nbr))))[:3, :]
    points_sweep = remove_close(points_sweep.T)
    times = sweep["time_lag"] * np.ones((points_sweep.shape[0], 1))
    return points_sweep, times


def load_sweeps(info: Dict, nsweeps: int,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """(N, 5) = (x, y, z, intensity, time_lag) combined cloud."""
    points = read_file(info["lidar_path"])
    pts_list = [points]
    times_list = [np.zeros((points.shape[0], 1), np.float32)]
    sweeps = info.get("sweeps", [])
    if len(sweeps) > 0:
        gen = rng or np.random.default_rng()
        for i in gen.choice(len(sweeps), min(nsweeps - 1, len(sweeps)),
                            replace=False):
            ps, ts = read_sweep(sweeps[i])
            pts_list.append(ps)
            times_list.append(ts)
    pts = np.concatenate(pts_list).astype(np.float32)
    times = np.concatenate(times_list).astype(np.float32)
    return np.hstack([pts, times])


def cbgs_resample(infos: List[Dict], class_names: Sequence[str],
                  rng: Optional[np.random.Generator] = None) -> List[Dict]:
    """Class-balanced resampling (nuscenes.py:86-121)."""
    gen = rng or np.random.default_rng()
    cls_infos = {n: [] for n in class_names}
    for info in infos:
        for name in set(info["gt_names"]):
            if name in class_names:
                cls_infos[name].append(info)
    dup = sum(len(v) for v in cls_infos.values())
    dist = {k: len(v) / max(dup, 1) for k, v in cls_infos.items()}
    frac = 1.0 / len(class_names)
    out = []
    for name in class_names:
        v = cls_infos[name]
        ratio = frac / max(dist[name], 1e-9)
        if len(v):
            picks = gen.choice(len(v), int(len(v) * ratio))
            out += [v[i] for i in picks]
    return out


def _class_ids(names, class_names) -> np.ndarray:
    return np.array([class_names.index(n) + 1 for n in names], np.int32)


class NuScenesDataset:
    def __init__(self, info_path: str, root_path: str = "",
                 nsweeps: int = 10, class_names=NUSC_CLASSES,
                 mode: str = "train", use_cbgs: bool = True,
                 pc_range=(-54, -54, -5.0, 54, 54, 3.0),
                 voxel_size=(0.075, 0.075, 0.2), max_points_in_voxel=10,
                 max_voxels=(120000, 160000), out_size_factor=8,
                 db_sampler=None, seed: int = 0,
                 tt_rotation: float = 0.0, double_flip: bool = False):
        with open(info_path, "rb") as f:
            infos = pickle.load(f)
        if isinstance(infos, dict):
            merged = []
            for v in infos.values():
                merged += v
            infos = merged
        self.rng = np.random.default_rng(seed)
        if mode == "train" and use_cbgs:
            infos = cbgs_resample(infos, class_names, self.rng)
        self.infos = infos
        self.root_path = root_path
        self.nsweeps = nsweeps
        self.class_names = list(class_names)
        self.mode = mode
        self.pc_range = pc_range
        self.voxel_size = voxel_size
        self.max_points_in_voxel = max_points_in_voxel
        self.max_voxels = max_voxels[0] if mode == "train" else max_voxels[1]
        self.out_size_factor = out_size_factor
        self.db_sampler = db_sampler
        self.tt_rotation = tt_rotation   # radians, val-mode TTA input rotation
        self.double_flip = double_flip   # val-mode 4-flip TTA

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, index: int) -> Dict:
        info = self.infos[index]
        points = load_sweeps(info, self.nsweeps, self.rng)
        sample = {"token": info.get("token", str(index))}

        if self.mode == "train":
            names = np.asarray(info["gt_names"]).reshape(-1)
            boxes = np.asarray(info["gt_boxes"], np.float32).reshape(-1, 9)
            keep = ~np.isin(names, ["DontCare", "ignore", "UNKNOWN"])
            boxes, names = boxes[keep], names[keep]

            in_cls = np.isin(names, self.class_names)
            if self.db_sampler is not None:
                sampled = self.db_sampler.sample_all(boxes, names, self.rng)
                if sampled is not None:
                    names = np.concatenate([names, sampled["gt_names"]])
                    boxes = np.concatenate([boxes, sampled["gt_boxes"]])
                    in_cls = np.concatenate(
                        [in_cls, np.ones(len(sampled["gt_names"]), bool)])
                    points = np.concatenate([sampled["points"], points])

            boxes, names = boxes[in_cls], names[in_cls]
            classes = _class_ids(names, self.class_names)

            points, boxes = dp.global_augment(points, boxes, self.rng)
            self.rng.shuffle(points)

            sample["targets"] = dp.assign_label(
                boxes, classes, pc_range=self.pc_range,
                voxel_size=self.voxel_size,
                out_size_factor=self.out_size_factor)
            sample["gt_boxes"] = boxes
            sample["gt_classes"] = classes

        if self.mode != "train" and "gt_boxes" in info:
            # the unaugmented GT for the devkit-free evaluator
            # (eval/nuscenes_eval.py); the reference reloads GT through the
            # devkit at eval time (nuscenes.py:208)
            names = np.asarray(info["gt_names"]).reshape(-1)
            boxes = np.asarray(info["gt_boxes"], np.float32).reshape(-1, 9)
            keep = np.isin(names, self.class_names)
            sample["gt_boxes"] = boxes[keep]
            sample["gt_classes"] = _class_ids(names[keep], self.class_names)
            if "gt_attributes" in info:
                sample["gt_attributes"] = np.asarray(
                    info["gt_attributes"], object)[keep]
            if "gt_num_pts" in info:
                sample["gt_num_pts"] = np.asarray(info["gt_num_pts"])[keep]

        if self.mode != "train" and self.tt_rotation != 0.0:
            # TTA input rotation in the reference's sense (preprocess.py:
            # 153-157: rotation_points_single_angle on the raw points)
            from ..ops.box_np import rotation_points_single_angle
            points = points.copy()
            points[:, :3] = rotation_points_single_angle(
                points[:, :3], self.tt_rotation, axis=2)

        voxels, coords_zyx, nppv = dp.points_to_voxel(
            points, self.voxel_size, self.pc_range,
            self.max_points_in_voxel, self.max_voxels)
        sample.update({"voxels": voxels, "coords_zyx": coords_zyx,
                       "num_points": nppv})

        if self.mode != "train" and self.double_flip:
            sample["flip_variants"] = make_double_flip_variants(
                points, self.voxel_size, self.pc_range,
                self.max_points_in_voxel, self.max_voxels)
        return sample


def make_double_flip_variants(points, voxel_size, pc_range,
                              max_points_in_voxel, max_voxels):
    """The inputs of 4-flip TTA (pipelines/test_aug.py:8-32 DoubleFlip and
    the Voxelization double_flip branch, preprocess.py:219-267): the
    [y-flip, x-flip, xy-flip] voxelizations (the unflipped one is the
    sample itself), in the order `models/center_head.double_flip_fuse`
    takes."""
    variants = []
    for fy, fx in ((True, False), (False, True), (True, True)):
        p = points.copy()
        if fy:
            p[:, 1] = -p[:, 1]
        if fx:
            p[:, 0] = -p[:, 0]
        voxels, coords_zyx, nppv = dp.points_to_voxel(
            p, voxel_size, pc_range, max_points_in_voxel, max_voxels)
        variants.append({"voxels": voxels, "coords_zyx": coords_zyx,
                         "num_points": nppv})
    return variants


class SyntheticNuScenes:
    """Synthetic frames when nuScenes data is absent (tests, the chip
    smoke, det_train --synthetic). With `tt_rotation` (radians) the points
    are rotated before voxelization and the boxes stay in the original
    frame, as in the reference's val TTA; `double_flip` adds the three
    flipped voxelizations (`make_double_flip_variants`)."""

    def __init__(self, length: int = 8, mode: str = "val", seed: int = 0,
                 n_points: int = 200000,
                 pc_range=(-54, -54, -5.0, 54, 54, 3.0),
                 voxel_size=(0.075, 0.075, 0.2), max_points_in_voxel=10,
                 max_voxels=120000, out_size_factor=8,
                 tt_rotation: float = 0.0, double_flip: bool = False):
        if mode not in ("train", "val"):
            raise ValueError(f"mode must be train or val, got {mode!r}")
        self.length = length
        self.mode = mode
        self.seed = seed
        self.n_points = n_points
        self.pc_range = pc_range
        self.voxel_size = voxel_size
        self.max_points_in_voxel = max_points_in_voxel
        self.max_voxels = max_voxels
        self.out_size_factor = out_size_factor
        self.tt_rotation = tt_rotation
        self.double_flip = double_flip

    def __len__(self):
        return self.length

    def _draw_points(self, rng: np.random.Generator) -> np.ndarray:
        n = self.n_points
        r = np.sqrt(rng.uniform(1, 54 ** 2, n))
        th = rng.uniform(0, 2 * np.pi, n)
        z = rng.normal(-1.0, 0.8, n)
        return np.stack([r * np.cos(th), r * np.sin(th), z,
                         rng.uniform(0, 255, n), rng.uniform(0, 0.45, n)],
                        1).astype(np.float32)

    def points(self, index: int) -> np.ndarray:
        """The frame's raw (N, 5) float32 points [x y z intensity t]."""
        return self._draw_points(np.random.default_rng(self.seed + index))

    @staticmethod
    def draw_boxes(rng: np.random.Generator):
        """5-39 boxes (N, 9) of the ten classes (1-based ids), drawn after
        the points from the frame's generator."""
        n_obj = rng.integers(5, 40)
        boxes = np.zeros((n_obj, 9), np.float32)
        boxes[:, 0:2] = rng.uniform(-50, 50, (n_obj, 2))
        boxes[:, 2] = rng.uniform(-1.5, 0.5, n_obj)
        boxes[:, 3:6] = rng.uniform(0.5, 4.0, (n_obj, 3))
        boxes[:, 6:8] = rng.normal(0, 2, (n_obj, 2))
        boxes[:, 8] = rng.uniform(-np.pi, np.pi, n_obj)
        classes = rng.integers(1, 11, n_obj).astype(np.int32)
        return boxes, classes

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.default_rng(self.seed + index)
        pts = self._draw_points(rng)
        sample = {"token": f"synthetic_{index}"}
        if self.mode == "train":
            boxes, classes = self.draw_boxes(rng)
            sample["targets"] = dp.assign_label(
                boxes, classes, pc_range=self.pc_range,
                voxel_size=self.voxel_size,
                out_size_factor=self.out_size_factor)
            sample["gt_boxes"] = boxes
            sample["gt_classes"] = classes
        if self.tt_rotation != 0.0:
            from ..ops.box_np import rotation_points_single_angle
            pts[:, :3] = rotation_points_single_angle(
                pts[:, :3], self.tt_rotation, axis=2)
        voxels, coords_zyx, nppv = dp.points_to_voxel(
            pts, self.voxel_size, self.pc_range, self.max_points_in_voxel,
            self.max_voxels)
        sample.update({"voxels": voxels, "coords_zyx": coords_zyx,
                       "num_points": nppv})
        if self.double_flip:
            sample["flip_variants"] = make_double_flip_variants(
                pts, self.voxel_size, self.pc_range,
                self.max_points_in_voxel, self.max_voxels)
        return sample


# ---------------------------------------------------------------------------
# synthetic files in the dataset's layout

INFO_NAME = "infos_{split}_{nsweeps}sweeps_withvelo_filter_True.pkl"
# the LIDAR_TOP mount of the nuScenes car (about its calibrated_sensor
# record): 0.94 m ahead, 1.84 m up, turned by -90 degrees about z
SENSOR_TRANSLATION = (0.943713, 0.0, 1.84023)
SENSOR_YAW = -np.pi / 2
FRAMES_PER_SCENE = 4
SWEEP_DT = 0.05            # s between sweeps (the lidar's 20 Hz)


def _yaw_quat(yaw: float):
    return (float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2)))


def write_synthetic_infos(root: str, n_frames: Union[int, Dict[str, int]],
                          nsweeps: int = 10, seed: int = 0,
                          n_points: int = 200000) -> Dict[str, str]:
    """Write synthetic frames in the nuScenes layout under `root`, for runs
    without the dataset, and their info pkls (the schema of
    tools/create_data.nuscenes_data_prep). `n_frames` is the number of
    keyframes of each of the train and val splits, or a dict {split: n}.
    Returns {split: info pkl path}.

    Keyframe i of a split is `SyntheticNuScenes(seed=seed).points` of a
    global index, `n_points` points in the keyframe's lidar frame, split
    evenly over the keyframe file (`samples/LIDAR_TOP/`) and its nsweeps - 1
    sweep files (`sweeps/LIDAR_TOP/`), each written in its own sensor frame:
    the ego drives 10 m/s along its heading and turns 0.02 rad a sweep, so
    every `transform_matrix` (sensor -> global -> keyframe lidar) is far
    from the identity and `load_sweeps` gives the frame's points back. The
    first keyframe of each scene of FRAMES_PER_SCENE has no previous sweep:
    only its keyframe file is written, and its sweeps repeat the keyframe
    itself with transform_matrix None and time_lag 0, as nuscenes_data_prep
    writes them. The GT boxes are
    `SyntheticNuScenes.draw_boxes` plus two "ignore" boxes (1 m cubes about
    two of the frame's points), named by class,
    with velocity, attribute and point count; boxes holding no point are
    dropped (filter_zero)."""
    from ..eval.submission import _attr_for
    from ..ops.box_np import points_in_rbbox
    from ..tools.create_data import transform_matrix

    if isinstance(n_frames, int):
        n_frames = {"train": n_frames, "val": n_frames}
    source = SyntheticNuScenes(seed=seed, n_points=n_points)
    cs_t = np.asarray(SENSOR_TRANSLATION)
    cs_q = _yaw_quat(SENSOR_YAW)
    ref_from_car = transform_matrix(cs_t, cs_q, inverse=True)
    car_from_sensor = transform_matrix(cs_t, cs_q)
    for sub in ("samples/LIDAR_TOP", "sweeps/LIDAR_TOP"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    def pose(scene: int, t: float):
        """The ego's (translation, yaw) at time t of a scene."""
        yaw = 0.3 * scene + 0.4 * t
        d = 10.0 * t
        return (np.array([200.0 * scene + d * np.cos(yaw),
                          50.0 * scene + d * np.sin(yaw), 0.0]), yaw)

    out = {}
    index = 0
    for si, (split, n) in enumerate(n_frames.items()):
        infos = []
        for k in range(n):
            scene = 100 * si + k // FRAMES_PER_SCENE
            first = k % FRAMES_PER_SCENE == 0
            t_key = 0.5 * (k % FRAMES_PER_SCENE)
            ego_t, ego_yaw = pose(scene, t_key)
            car_from_global = transform_matrix(ego_t, _yaw_quat(ego_yaw),
                                               inverse=True)
            token = f"synthetic_{split}_{k:04d}"
            pts = source.points(index)
            rng = np.random.default_rng(seed + 7919 * (index + 1))
            index += 1
            chunks = np.array_split(pts, nsweeps)
            held = chunks[0] if first else pts
            lidar_path = os.path.join(root, "samples", "LIDAR_TOP",
                                      token + ".pcd.bin")
            chunks[0].tofile(lidar_path)
            sweeps = []
            for j in range(1, nsweeps):
                if first:
                    sweeps.append({"lidar_path": lidar_path,
                                   "transform_matrix": None,
                                   "time_lag": 0.0})
                    continue
                sw_t, sw_yaw = pose(scene, t_key - SWEEP_DT * j)
                tm = (ref_from_car @ car_from_global
                      @ transform_matrix(sw_t, _yaw_quat(sw_yaw))
                      @ car_from_sensor)
                p = chunks[j].copy()
                xyz1 = np.concatenate([p[:, :3], np.ones((len(p), 1))], 1)
                p[:, :3] = (xyz1 @ np.linalg.inv(tm).T)[:, :3]
                path = os.path.join(root, "sweeps", "LIDAR_TOP",
                                    f"{token}_{j:02d}.pcd.bin")
                p.astype(np.float32).tofile(path)
                sweeps.append({"lidar_path": path, "transform_matrix": tm,
                               "time_lag": SWEEP_DT * j})
            boxes, classes = SyntheticNuScenes.draw_boxes(rng)
            names = np.array([NUSC_CLASSES[c - 1] for c in classes])
            ign = np.zeros((2, 9), np.float32)      # about a point each
            ign[:, 0:3] = held[rng.integers(0, len(held), 2), :3]
            ign[:, 3:6] = 1.0
            boxes = np.concatenate([boxes, ign])
            names = np.concatenate([names, ["ignore", "ignore"]])
            npts = points_in_rbbox(held, boxes).sum(0).astype(np.int32)
            keep = npts > 0
            boxes, names, npts = boxes[keep], names[keep], npts[keep]
            attrs = np.array([_attr_for(nm, b[6:8]) if nm in NUSC_CLASSES
                              else "" for nm, b in zip(names, boxes)],
                             object)
            infos.append({
                "lidar_path": lidar_path, "token": token, "sweeps": sweeps,
                "ref_from_car": ref_from_car,
                "car_from_global": car_from_global,
                "timestamp": 100.0 * scene + t_key,
                "gt_boxes": boxes.astype(np.float32), "gt_names": names,
                "gt_boxes_velocity": boxes[:, 6:8].copy(),
                "gt_attributes": attrs, "gt_num_pts": npts})
        path = os.path.join(root, INFO_NAME.format(split=split,
                                                   nsweeps=nsweeps))
        with open(path, "wb") as f:
            pickle.dump(infos, f)
        out[split] = path
    return out
