"""Single-frame detection inference on the port.

PyTorch counterpart of `link_tpu/inference.py:SingleFramePredictor` (the
loop of the reference ROS node, detection/tools/single_infernece_ros.py:
92-170): voxelize one cloud on the host in one native pass, run the
VoxelNet forward and the box decode on the device, rotated NMS (on the
host through the native library, or with `device_nms=True` on the device
through the `rotated_nms` kernel), then per-class score floors. The test
config comes from `DEFAULT_TEST_CFG`, a py config's `test_cfg` or both;
the weights from a checkpoint that `train.checkpoint.save_checkpoint`
wrote, a reference-keyed `state_dict`, or a seed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import native
from .data import det_pipeline as dp
from .models.center_head import decode_boxes, device_nms
from .models.voxelnet import VoxelNet
from .ops.nms import rotate_nms_pcdet
from .utils.config import load_py_config

DEFAULT_TEST_CFG = dict(
    post_center_limit_range=[-61.2, -61.2, -10.0, 61.2, 61.2, 10.0],
    max_per_img=500,
    nms_pre_max_size=1000,
    nms_post_max_size=83,
    nms_iou_threshold=0.2,
    score_threshold=0.1,
    pc_range=[-54, -54],
    voxel_size=[0.075, 0.075],
    out_size_factor=8,
)

# per-class score floors from the reference ROS node
# (single_infernece_ros.py:42-52); keys are global label ids
NUSC_CLASS_SCORE_FLOOR = {
    0: 0.4, 1: 0.4, 2: 0.4, 3: 0.3, 4: 0.4,
    5: 0.4, 6: 0.15, 7: 0.15, 8: 0.10, 9: 0.10,
}


def config_test_cfg(path: str) -> Dict:
    """The predictor's test-config entries of a py config's `test_cfg`
    (link_tpu/inference.py:67-80)."""
    t = load_py_config(path).test_cfg
    return dict(post_center_limit_range=list(t.post_center_limit_range),
                max_per_img=t.max_per_img,
                nms_pre_max_size=t.nms.nms_pre_max_size,
                nms_post_max_size=t.nms.nms_post_max_size,
                nms_iou_threshold=t.nms.nms_iou_threshold,
                score_threshold=t.score_threshold,
                pc_range=list(t.pc_range), voxel_size=list(t.voxel_size),
                out_size_factor=t.out_size_factor)


def masked_rows(task_outs) -> List[Tuple[np.ndarray, ...]]:
    """Per task, the (boxes, scores, labels) of batch row 0 where its mask
    is set, on the host: the tasks' rows are packed and compacted on the
    device and copied in one transfer."""
    packed = torch.cat([torch.cat(
        [boxes[0], scores[0, :, None], labels[0, :, None].float(),
         torch.full_like(scores[0, :, None], t)], 1)
        for t, (boxes, scores, labels, _) in enumerate(task_outs)])
    mask = torch.cat([m[0] for *_, m in task_outs])
    rows = packed[mask].cpu().numpy()
    out = []
    for t in range(len(task_outs)):
        r = rows[rows[:, -1] == t]
        out.append((r[:, :9], r[:, 9], r[:, 10].astype(np.int32)))
    return out


def host_nms(rows, cfg: Dict, device_nms: bool = False,
             impl: str = "native") -> Dict[str, np.ndarray]:
    """`masked_rows` after the host's rotated NMS per task under `cfg`'s
    threshold and caps (none when `device_nms`: the rows are already the
    device NMS's keep), concatenated over the tasks: {box3d_lidar, scores,
    label_preds}."""
    boxes_l, scores_l, labels_l = [], [], []
    for bx, sc, lb in rows:
        if len(bx) == 0:
            continue
        if not device_nms:
            keep = rotate_nms_pcdet(
                bx[:, [0, 1, 2, 3, 4, 5, 8]], sc,
                thresh=cfg["nms_iou_threshold"],
                pre_maxsize=cfg["nms_pre_max_size"],
                post_max_size=cfg["nms_post_max_size"], impl=impl)
            bx, sc, lb = bx[keep], sc[keep], lb[keep]
        boxes_l.append(bx)
        scores_l.append(sc)
        labels_l.append(lb)
    if not boxes_l:
        return {"box3d_lidar": np.zeros((0, 9), np.float32),
                "scores": np.zeros(0, np.float32),
                "label_preds": np.zeros(0, np.int64)}
    return {"box3d_lidar": np.concatenate(boxes_l),
            "scores": np.concatenate(scores_l),
            "label_preds": np.concatenate(labels_l)}


class SingleFramePredictor:
    """Voxelize -> VoxelNet forward -> decode -> rotated NMS for one point
    cloud at a time. `predict` is the whole loop; `voxelize` (host),
    `forward` (device work, and device NMS when asked for; returns device
    tensors) and `postprocess` (`masked_rows` to the host, `host_nms`,
    `apply_floors`) are its three stages.

    config: a py config whose `test_cfg` updates DEFAULT_TEST_CFG, as the
    JAX predictor maps it; test_cfg: entries that update it after that.
    checkpoint: a file of `train.checkpoint.save_checkpoint`, whose "model"
    entry is loaded strictly; state_dict: reference-keyed weights; without
    either the weights are drawn from `seed`. host_impl: "native" (the C++
    voxelizer and NMS) or "numpy" (their NumPy twins)."""

    def __init__(self, config: Optional[str] = None,
                 checkpoint: Optional[str] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 max_voxels: int = 160000,
                 class_score_floor: Optional[Dict[int, float]] = None,
                 seed: int = 0, capacity: int = 163840,
                 grid_shape=(1440, 1440, 40),
                 test_cfg: Optional[Dict] = None, dtype: str = "float32",
                 device="cuda", device_nms: bool = False,
                 host_impl: str = "native"):
        if checkpoint is not None and state_dict is not None:
            raise ValueError("give a checkpoint or a state_dict, not both")
        native.check_impl(host_impl)
        self.cfg = dict(DEFAULT_TEST_CFG)
        if config:
            self.cfg.update(config_test_cfg(config))
        if test_cfg:
            self.cfg.update(test_cfg)
        self.score_floor = (NUSC_CLASS_SCORE_FLOOR
                            if class_score_floor is None
                            else class_score_floor)
        self.voxel_size = (self.cfg["voxel_size"][0],
                           self.cfg["voxel_size"][1], 0.2)
        self.point_range = (self.cfg["pc_range"][0], self.cfg["pc_range"][1],
                            -5.0, -self.cfg["pc_range"][0],
                            -self.cfg["pc_range"][1], 3.0)
        self.max_voxels = max_voxels
        self.cap = capacity
        self.device = torch.device(device)
        self.device_nms = device_nms
        self.host_impl = host_impl
        if checkpoint:
            state_dict = torch.load(checkpoint, map_location="cpu",
                                    weights_only=True)["model"]
        gen = None if state_dict is not None else \
            torch.Generator().manual_seed(seed)
        self.model = VoxelNet(num_input_features=5, batch_size=1,
                              grid_shape=tuple(grid_shape),
                              capacities=(capacity, capacity // 2,
                                          capacity // 4, capacity // 8),
                              dtype=dtype, device=device, generator=gen)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.model.eval()
        self.num_classes = [len(t) for t in self.model.tasks]

    def voxelize(self, points: np.ndarray) -> Dict[str, np.ndarray]:
        """points (N, >= 5) -> the collated numpy batch."""
        if points.shape[1] < 5:
            pad = np.zeros((len(points), 5 - points.shape[1]), np.float32)
            points = np.concatenate([points.astype(np.float32), pad], 1)
        if self.host_impl == "native":
            vs = np.asarray(self.voxel_size, np.float32)
            pr = np.asarray(self.point_range, np.float32)
            grid = np.round((pr[3:6] - pr[:3]) / vs).astype(np.int32)
            return native.voxelize_collated(points, vs, pr, grid, 10,
                                            self.max_voxels, self.cap,
                                            num_feats=points.shape[1])
        voxels, coords_zyx, nppv = dp.points_to_voxel(
            points, self.voxel_size, self.point_range, 10, self.max_voxels,
            impl="numpy")
        return dp.collate_det([{"voxels": voxels, "coords_zyx": coords_zyx,
                                "num_points": nppv}], self.cap)

    def forward(self, batch: Dict[str, np.ndarray]):
        """Device forward + decode of a collated batch, then device NMS
        when the predictor was made with it: per task (boxes, scores,
        labels, mask) on the device, the mask the post-NMS keep in that
        mode."""
        with torch.inference_mode():
            preds = self.model(*dp.det_inputs(batch, self.device))
            outs = decode_boxes(preds, self.cfg, self.num_classes)
            if self.device_nms:
                outs = device_nms(outs, self.cfg)
            return outs

    def postprocess(self, task_outs) -> Dict[str, np.ndarray]:
        """The masked rows to the host, host rotated NMS per task unless
        the mask is already the device NMS's keep, then the per-class score
        floors."""
        return self.apply_floors(self.host_nms(masked_rows(task_outs)))

    def host_nms(self, rows) -> Dict[str, np.ndarray]:
        """`host_nms` under the predictor's test config and mode."""
        return host_nms(rows, self.cfg, self.device_nms, self.host_impl)

    def apply_floors(self, det: Dict[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
        """Drop the detections below their class's score floor."""
        if not self.score_floor or not len(det["scores"]):
            return det
        floors = np.asarray([self.score_floor.get(int(l), 0.0)
                             for l in det["label_preds"]])
        keep = det["scores"] >= floors
        return {k: v[keep] for k, v in det.items()}

    def predict(self, points: np.ndarray) -> Dict[str, np.ndarray]:
        """points (N, >= 5) float32 -> {box3d_lidar, scores, label_preds}
        after NMS and the per-class score floors."""
        return self.postprocess(self.forward(self.voxelize(points)))
