"""Offline nuScenes data preparation of the PyTorch port.

A copy of tools/create_data.py (reference: detection/tools/create_data.py +
det3d/datasets/nuscenes/nusc_common.py:354-608 +
datasets/utils/create_gt_database.py:16).

nuscenes_data_prep builds:
  * infos_{train,val}_10sweeps_withvelo_filter_True.pkl — per-keyframe
    lidar path, 10-sweep transform chains, gt boxes (9-dof with velocity);
  * dbinfos_train_10sweeps_withvelo.pkl + gt_database/ — cropped gt point
    clusters for GT-AUG.

nuscenes_data_prep requires the nuscenes-devkit, imported when it runs
(the port does not depend on it); without it the command exits with a
message. build_gt_database needs only the info pkl and the files it names.

Usage:
  python3 -m link_tpu_torch.tools.create_data nuscenes_data_prep \
      --root-path data/nuScenes [--version v1.0-trainval] [--nsweeps 10]
  python3 -m link_tpu_torch.tools.create_data gt_database \
      --root-path data/nuScenes --info-path <infos_train_...pkl>
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def _quaternion_matrix(q):
    """4x4 homogeneous rotation from (w, x, y, z)."""
    w, x, y, z = q
    m = np.eye(4)
    m[:3, :3] = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    return m


def transform_matrix(translation, rotation_q, inverse=False):
    """nuscenes-devkit geometry_utils.transform_matrix."""
    tm = _quaternion_matrix(rotation_q)
    if inverse:
        rot = tm[:3, :3].T
        tm = np.eye(4)
        tm[:3, :3] = rot
        tm[:3, 3] = rot @ (-np.asarray(translation))
    else:
        tm[:3, 3] = translation
    return tm


def nuscenes_data_prep(root_path: str, version: str = "v1.0-trainval",
                       nsweeps: int = 10, filter_zero: bool = True):
    try:
        from nuscenes import NuScenes
        from nuscenes.utils import splits
    except ImportError as e:
        raise SystemExit(
            "nuscenes-devkit is required for info generation; install it "
            "alongside the raw dataset, then re-run.") from e

    nusc = NuScenes(version=version, dataroot=root_path, verbose=True)
    train_scenes = splits.train if "trainval" in version else splits.mini_train
    val_scenes = splits.val if "trainval" in version else splits.mini_val
    test = "test" in version

    from ..data.nuscenes import GENERAL_TO_DETECTION

    train_infos, val_infos = [], []
    for sample in nusc.sample:
        scene = nusc.get("scene", sample["scene_token"])["name"]
        sd_token = sample["data"]["LIDAR_TOP"]
        sd = nusc.get("sample_data", sd_token)
        cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = nusc.get("ego_pose", sd["ego_pose_token"])

        ref_from_car = transform_matrix(cs["translation"], cs["rotation"],
                                        inverse=True)
        car_from_global = transform_matrix(pose["translation"],
                                           pose["rotation"], inverse=True)
        ref_time = 1e-6 * sd["timestamp"]

        info = {
            "lidar_path": os.path.join(root_path, sd["filename"]),
            "token": sample["token"],
            "sweeps": [],
            "ref_from_car": ref_from_car,
            "car_from_global": car_from_global,
            "timestamp": ref_time,
        }

        # accumulate nsweeps-1 previous sweeps (nusc_common.py:419-482)
        sweeps = []
        cur = sd
        while len(sweeps) < nsweeps - 1:
            if cur["prev"] == "":
                if len(sweeps) == 0:
                    sweeps.append({
                        "lidar_path": info["lidar_path"],
                        "transform_matrix": None,
                        "time_lag": 0.0,
                    })
                else:
                    sweeps.append(sweeps[-1])
            else:
                cur = nusc.get("sample_data", cur["prev"])
                cur_pose = nusc.get("ego_pose", cur["ego_pose_token"])
                gfc = transform_matrix(cur_pose["translation"],
                                       cur_pose["rotation"])
                cur_cs = nusc.get("calibrated_sensor",
                                  cur["calibrated_sensor_token"])
                cfs = transform_matrix(cur_cs["translation"],
                                       cur_cs["rotation"])
                tm = ref_from_car @ car_from_global @ gfc @ cfs
                sweeps.append({
                    "lidar_path": os.path.join(root_path, cur["filename"]),
                    "transform_matrix": tm,
                    "time_lag": ref_time - 1e-6 * cur["timestamp"],
                })
        info["sweeps"] = sweeps

        if not test:
            _, boxes, _ = nusc.get_sample_data(sd_token)
            annotations = [nusc.get("sample_annotation", t)
                           for t in sample["anns"]]
            locs = np.array([b.center for b in boxes]).reshape(-1, 3)
            dims = np.array([b.wlh for b in boxes]).reshape(-1, 3)
            rots = np.array([b.orientation.yaw_pitch_roll[0]
                             for b in boxes]).reshape(-1, 1)
            velocity = np.array(
                [nusc.box_velocity(t)[:2] for t in sample["anns"]]
            ).reshape(-1, 2)
            # rotate velocity into lidar frame
            R = (ref_from_car @ car_from_global)[:3, :3]
            vel3 = np.concatenate([velocity, np.zeros((len(velocity), 1))], 1)
            velocity = (vel3 @ R.T)[:, :2]
            names = np.array([GENERAL_TO_DETECTION.get(b.name, "ignore")
                              for b in boxes])
            # box yaw: nusc devkit yaw -> reference convention (-yaw - pi/2)
            gt_boxes = np.concatenate(
                [locs, dims, velocity, -rots - np.pi / 2], axis=1)
            # attribute names for devkit-faithful AAE scoring
            # (eval/nuscenes_eval.py); an annotation may carry 0 or 1 attrs
            attrs = np.array(
                [nusc.get("attribute", a["attribute_tokens"][0])["name"]
                 if a["attribute_tokens"] else "" for a in annotations],
                object)
            npts = np.array([a["num_lidar_pts"] + a["num_radar_pts"]
                             for a in annotations])
            if filter_zero:
                mask = npts > 0
                gt_boxes, names = gt_boxes[mask], names[mask]
                attrs, npts = attrs[mask], npts[mask]
                velocity = velocity[mask]
            info["gt_boxes"] = gt_boxes.astype(np.float32)
            info["gt_names"] = names
            info["gt_boxes_velocity"] = velocity
            info["gt_attributes"] = attrs
            info["gt_num_pts"] = npts.astype(np.int32)

        (val_infos if scene in val_scenes else train_infos).append(info)

    suffix = f"_{nsweeps}sweeps_withvelo_filter_{filter_zero}.pkl"
    with open(os.path.join(root_path, "infos_train" + suffix), "wb") as f:
        pickle.dump(train_infos, f)
    with open(os.path.join(root_path, "infos_val" + suffix), "wb") as f:
        pickle.dump(val_infos, f)
    print(f"train {len(train_infos)} / val {len(val_infos)} infos written")
    return train_infos, val_infos


def build_gt_database(root_path: str, info_path: str, nsweeps: int = 10):
    from ..data.gt_aug import create_gt_database
    from ..data.nuscenes import load_sweeps

    with open(info_path, "rb") as f:
        infos = pickle.load(f)

    class _PointsDS:
        def __len__(self):
            return len(infos)

        def __getitem__(self, i):
            info = infos[i]
            pts = load_sweeps(info, nsweeps)
            return {"points": pts, "gt_boxes": info["gt_boxes"],
                    "gt_names": info["gt_names"]}

    return create_gt_database(_PointsDS(), root_path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("command", choices=["nuscenes_data_prep", "gt_database"])
    ap.add_argument("--root-path", required=True)
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--nsweeps", type=int, default=10)
    ap.add_argument("--info-path", default=None)
    args = ap.parse_args(argv)
    if args.command == "nuscenes_data_prep":
        nuscenes_data_prep(args.root_path, args.version, args.nsweeps)
    else:
        if not args.info_path:
            ap.error("gt_database needs --info-path")
        build_gt_database(args.root_path, args.info_path, args.nsweeps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
