"""Waymo Open Dataset preparation of the PyTorch port: TFRecord -> frame
pickles -> info pkls -> GT database.

A copy of tools/create_data_waymo.py (reference: detection/det3d/datasets/
waymo/waymo_converter.py (TFRecord decode, toolkit-gated),
waymo_decoder.py (frame schema), and waymo_common.py:_fill_infos (sweep
chains with vehicle-pose transform matrices)). The decode step needs the
`waymo-open-dataset` toolkit + tensorflow, imported when it runs (the port
does not depend on them; without them the command exits with a message);
info and gt-database generation run on the decoded pickle tree alone
(`data/waymo.write_synthetic_tree` writes one of made frames).

Usage:
  python3 -m link_tpu_torch.tools.create_data_waymo decode \
      --records 'data/Waymo/*.tfrecord' --out data/Waymo
  python3 -m link_tpu_torch.tools.create_data_waymo infos \
      --root data/Waymo --split train --nsweeps 2
  python3 -m link_tpu_torch.tools.create_data_waymo gt-db \
      --root data/Waymo --split train
"""

import argparse
import glob
import os
import pickle

import numpy as np


def decode(args):
    try:
        import tensorflow.compat.v2 as tf
        from waymo_open_dataset import dataset_pb2
        from waymo_open_dataset.utils import frame_utils
    except ImportError as e:
        raise SystemExit(
            f"TFRecord decoding needs tensorflow + waymo-open-dataset: {e}\n"
            "Run this step where the toolkit is installed; the decoded "
            "pickle tree is all later steps need.")
    tf.enable_v2_behavior()

    def decode_frame(frame, fid):
        """Frame pickle in the reference's schema (waymo_decoder.py):
        merged first+second return point clouds with (intensity,
        elongation) features, the vehicle pose, and frame identity."""
        (ri, cp, _, rip) = \
            frame_utils.parse_range_image_and_camera_projection(frame)
        pts, pts_cp = frame_utils.convert_range_image_to_point_cloud(
            frame, ri, cp, rip, keep_polar_features=True)
        pts2, _ = frame_utils.convert_range_image_to_point_cloud(
            frame, ri, cp, rip, ri_index=1, keep_polar_features=True)
        # keep_polar_features rows: (range, intensity, elongation, x, y, z)
        all_pts = np.concatenate([np.concatenate(pts),
                                  np.concatenate(pts2)])
        return {
            "scene_name": frame.context.name,
            "frame_name": "{}_{}_{}".format(
                frame.context.name, frame.timestamp_micros,
                frame.timestamp_micros),
            "frame_id": fid,
            "veh_to_global": np.array(frame.pose.transform, np.float64),
            "lidars": {
                "points_xyz": all_pts[:, 3:6].astype(np.float32),
                "points_feature": all_pts[:, 1:3].astype(np.float32),
            },
        }

    def decode_annos(frame, fid):
        """Annos pickle in the reference schema (waymo_decoder.py:169-205):
        RAW waymo boxes [x y z l w h vx vy heading] with velocity rotated
        into the vehicle frame; the det3d conversion happens at info time
        (waymo_common.py:260-276), matching fill_infos below."""
        pose = np.reshape(np.array(frame.pose.transform, np.float64),
                          (4, 4))
        ref_rot_inv = pose[:3, :3].T
        objects = []
        for label in frame.laser_labels:
            b = label.box
            speed = np.array([label.metadata.speed_x,
                              label.metadata.speed_y, 0.0])
            ref_vel = (ref_rot_inv @ speed)[:2]
            objects.append({
                "id": label.id, "name": label.id,
                "label": int(label.type),
                "box": np.array(
                    [b.center_x, b.center_y, b.center_z, b.length, b.width,
                     b.height, ref_vel[0], ref_vel[1], b.heading],
                    np.float32),
                "num_points": label.num_lidar_points_in_box,
            })
        return {
            "scene_name": frame.context.name,
            "frame_name": "{}_{}_{}".format(
                frame.context.name, frame.timestamp_micros,
                frame.timestamp_micros),
            "frame_id": fid,
            "veh_to_global": np.array(frame.pose.transform, np.float64),
            "objects": objects,
        }
    lidar_dir = os.path.join(args.out, args.split, "lidar")
    anno_dir = os.path.join(args.out, args.split, "annos")
    os.makedirs(lidar_dir, exist_ok=True)
    os.makedirs(anno_dir, exist_ok=True)
    for seq, fname in enumerate(sorted(glob.glob(args.records))):
        ds = tf.data.TFRecordDataset(fname, compression_type="")
        for fid, data in enumerate(ds):
            frame = dataset_pb2.Frame()
            frame.ParseFromString(bytearray(data.numpy()))
            name = f"seq_{seq}_frame_{fid}.pkl"
            with open(os.path.join(lidar_dir, name), "wb") as f:
                pickle.dump(decode_frame(frame, fid), f)
            with open(os.path.join(anno_dir, name), "wb") as f:
                pickle.dump(decode_annos(frame, fid), f)
        print(f"seq {seq}: {fid + 1} frames")


def _pose_transforms(veh_to_global):
    """vehicle pose (4, 4) -> (global_from_car, car_from_global)
    (waymo_common.py:veh_pos_to_transform)."""
    m = np.reshape(np.asarray(veh_to_global, np.float64), (4, 4))
    inv = np.eye(4)
    inv[:3, :3] = m[:3, :3].T
    inv[:3, 3] = -m[:3, :3].T @ m[:3, 3]
    return m, inv


def fill_infos(args):
    """waymo_common.py:_fill_infos: per-frame info with an nsweeps-1 chain
    of previous frames re-projected into the keyframe vehicle frame."""
    root = os.path.join(args.root, args.split)
    frames = sorted(os.listdir(os.path.join(root, "lidar")))
    infos = []
    for frame_name in frames:
        anno_path = os.path.join(root, "annos", frame_name)
        with open(anno_path, "rb") as f:
            ref_obj = pickle.load(f)
        ref_time = 1e-6 * int(ref_obj["frame_name"].split("_")[-1])
        _, ref_from_global = _pose_transforms(ref_obj["veh_to_global"])

        seq = int(frame_name.split("_")[1])
        fid = int(frame_name.split("_")[3][:-4])
        sweeps = []
        prev = fid
        while len(sweeps) < args.nsweeps - 1:
            if prev <= 0:
                sweeps.append(sweeps[-1] if sweeps else {
                    "path": os.path.join(args.split, "lidar", frame_name),
                    "token": frame_name, "transform_matrix": None,
                    "time_lag": 0})
                continue
            prev -= 1
            cur_name = f"seq_{seq}_frame_{prev}.pkl"
            with open(os.path.join(root, "annos", cur_name), "rb") as f:
                cur_obj = pickle.load(f)
            global_from_car, _ = _pose_transforms(cur_obj["veh_to_global"])
            tm = ref_from_global @ global_from_car
            cur_time = 1e-6 * int(cur_obj["frame_name"].split("_")[-1])
            sweeps.append({
                "path": os.path.join(args.split, "lidar", cur_name),
                "token": cur_name, "transform_matrix": tm,
                "time_lag": ref_time - cur_time})

        info = {
            "path": os.path.join(args.split, "lidar", frame_name),
            "anno_path": os.path.join(args.split, "annos", frame_name),
            "token": frame_name, "timestamp": ref_time, "sweeps": sweeps,
            # global pose, needed by tools/waymo_track.py to lift boxes
            # into the global frame (reference reads it from the annos)
            "veh_to_global": np.asarray(ref_obj["veh_to_global"],
                                        np.float64),
        }
        # raw-pickle boxes -> det3d convention + names + zero-point drop
        # (waymo_common.py:260-276)
        type_list = ("UNKNOWN", "VEHICLE", "PEDESTRIAN", "SIGN", "CYCLIST")
        annos = ref_obj.get("objects", [])
        if annos:
            boxes = np.array([a["box"] for a in annos],
                             np.float32).reshape(-1, 9)
            boxes[:, -1] = -np.pi / 2 - boxes[:, -1]
            boxes[:, [3, 4]] = boxes[:, [4, 3]]
            names = np.array([type_list[a["label"]] for a in annos])
            npts = np.array([a.get("num_points", 0) for a in annos])
            mask = npts > 0
            info["gt_boxes"] = boxes[mask]
            info["gt_names"] = names[mask]
            info["gt_num_pts"] = npts[mask].astype(np.int32)
        else:
            info["gt_boxes"] = np.zeros((0, 9), np.float32)
            info["gt_names"] = np.zeros((0,), "<U16")
            info["gt_num_pts"] = np.zeros((0,), np.int32)
        infos.append(info)
    out = os.path.join(args.root,
                       f"infos_{args.split}_{args.nsweeps:02d}sweeps.pkl")
    with open(out, "wb") as f:
        pickle.dump(infos, f)
    print(f"{len(infos)} infos -> {out}")


def gt_db(args):
    from ..data.gt_aug import create_gt_database
    from ..data.waymo import WaymoDataset, load_waymo_sweeps

    class _GtView:
        """Adapter: yield raw points + gt for the database builder."""

        def __init__(self, ds):
            self.ds = ds

        def __len__(self):
            return len(self.ds)

        def __getitem__(self, i):
            info = self.ds.infos[i]
            frame = load_waymo_sweeps(info, self.ds.root_path, 1)
            return {"points": frame["points"],
                    "gt_boxes": np.asarray(info["gt_boxes"], np.float32),
                    "gt_names": np.asarray(info["gt_names"])}

    info_path = os.path.join(
        args.root, f"infos_{args.split}_{args.nsweeps:02d}sweeps.pkl")
    ds = WaymoDataset(info_path, args.root, mode="val")
    create_gt_database(_GtView(ds), args.root,
                       num_point_features=5)
    print("gt database written")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("decode")
    d.add_argument("--records", required=True)
    d.add_argument("--out", required=True)
    d.add_argument("--split", default="train")
    i = sub.add_parser("infos")
    i.add_argument("--root", required=True)
    i.add_argument("--split", default="train")
    i.add_argument("--nsweeps", type=int, default=1)
    g = sub.add_parser("gt-db")
    g.add_argument("--root", required=True)
    g.add_argument("--split", default="train")
    g.add_argument("--nsweeps", type=int, default=1)
    args = ap.parse_args(argv)
    {"decode": decode, "infos": fill_infos, "gt-db": gt_db}[args.cmd](args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
