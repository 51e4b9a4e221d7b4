"""Single-frame detection inference on the port.

PyTorch counterpart of `link_tpu/inference.py:SingleFramePredictor` (the
loop of the reference ROS node, detection/tools/single_infernece_ros.py:
92-170): voxelize one cloud on the host, run the VoxelNet forward and the
box decode on the device, rotated NMS on the host, then per-class score
floors. Weights come from a reference-keyed `state_dict` or are drawn from
a seed; checkpoint files are not read here.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .data import det_pipeline as dp
from .models.center_head import decode_boxes
from .models.voxelnet import VoxelNet
from .ops.nms import rotate_nms_pcdet

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


class SingleFramePredictor:
    """Voxelize -> VoxelNet forward -> decode -> rotated NMS for one point
    cloud at a time. `predict` is the whole loop; `voxelize`, `forward`
    (device work, returns device tensors) and `postprocess` (host NMS and
    floors) are its three stages."""

    def __init__(self, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 max_voxels: int = 160000,
                 class_score_floor: Optional[Dict[int, float]] = None,
                 seed: int = 0, capacity: int = 163840,
                 grid_shape=(1440, 1440, 40),
                 test_cfg: Optional[Dict] = None, dtype: str = "float32",
                 device="cuda"):
        self.cfg = dict(DEFAULT_TEST_CFG)
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
        voxels, coords_zyx, nppv = dp.points_to_voxel(
            points, self.voxel_size, self.point_range, 10, self.max_voxels)
        return dp.collate_det([{"voxels": voxels, "coords_zyx": coords_zyx,
                                "num_points": nppv}], self.cap)

    def forward(self, batch: Dict[str, np.ndarray]):
        """Device forward + decode of a collated batch: per task (boxes,
        scores, labels, mask) on the device."""
        with torch.inference_mode():
            preds = self.model(*dp.det_inputs(batch, self.device))
            return decode_boxes(preds, self.cfg, self.num_classes)

    def postprocess(self, task_outs) -> Dict[str, np.ndarray]:
        """Host rotated NMS per task, then the per-class score floors."""
        boxes_l, scores_l, labels_l = [], [], []
        for boxes, scores, labels, mask in task_outs:
            m = mask[0].cpu().numpy()
            bx = boxes[0].cpu().numpy()[m]
            sc = scores[0].cpu().numpy()[m]
            lb = labels[0].cpu().numpy()[m]
            if len(bx) == 0:
                continue
            keep = rotate_nms_pcdet(
                bx[:, [0, 1, 2, 3, 4, 5, 8]], sc,
                thresh=self.cfg["nms_iou_threshold"],
                pre_maxsize=self.cfg["nms_pre_max_size"],
                post_max_size=self.cfg["nms_post_max_size"])
            boxes_l.append(bx[keep])
            scores_l.append(sc[keep])
            labels_l.append(lb[keep])
        if not boxes_l:
            return {"box3d_lidar": np.zeros((0, 9), np.float32),
                    "scores": np.zeros(0, np.float32),
                    "label_preds": np.zeros(0, np.int64)}
        pb = np.concatenate(boxes_l)
        ps = np.concatenate(scores_l)
        pl = np.concatenate(labels_l)
        if self.score_floor:
            floors = np.asarray([self.score_floor.get(int(l), 0.0)
                                 for l in pl])
            keep = ps >= floors
            pb, ps, pl = pb[keep], ps[keep], pl[keep]
        return {"box3d_lidar": pb, "scores": ps, "label_preds": pl}

    def predict(self, points: np.ndarray) -> Dict[str, np.ndarray]:
        """points (N, >= 5) float32 -> {box3d_lidar, scores, label_preds}
        after NMS and the per-class score floors."""
        return self.postprocess(self.forward(self.voxelize(points)))
