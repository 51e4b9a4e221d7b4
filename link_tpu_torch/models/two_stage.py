"""Two-stage refinement (CenterPoint2-style), optional in the reference and
off in the published LinK configs.

PyTorch counterpart of `link_tpu/models/two_stage.py` (reference
detection/det3d/models/detectors/two_stage.py:9-156,
second_stage/bird_eye_view.py:10-60, roi_heads/roi_head.py:17-98 and
roi_head_template.py): the first stage's post-NMS proposals are described
by BEV features bilinearly sampled at 5 box points (the centre and the 4
BEV edge midpoints); an MLP RoI head predicts an IoU-style confidence and
a box refinement; the final score is sqrt(sigmoid(iou) * first score).

`RoIHead` keeps the reference's module layout and `state_dict` keys
(`shared_fc_layer.{0,1,4,5}`, `cls_layers.{0,1,4,5,7}`,
`reg_layers.{0,1,4,5,7}`: Conv1d(k=1) + BatchNorm1d + ReLU per layer, the
final biased Conv1d), so a reference RoI head loads directly; the
reference's Dropout after the first layer of each stack is an Identity, as
the JAX package omits it. Its BatchNorms move their running variance by the
biased batch variance, as flax's `nn.BatchNorm` does (`rpn.batch_norm_2d`).
`assign_roi_targets` and `_subsample_rois` are host NumPy copies of the JAX
package's, drawing from the caller's `np.random.default_rng` in the same
order, so both packages sample the same rois.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.box_np import boxes_iou3d, limit_period
from .rpn import batch_norm_2d


def bilinear_interpolate(fmap: torch.Tensor, xs: torch.Tensor,
                         ys: torch.Tensor) -> torch.Tensor:
    """fmap (H, W, C) sampled at float (xs, ys) in grid units, with the
    reference's boundary rule (center_utils.py bilinear_interpolate_torch):
    the weights come from the clamped integer corners, so a point wholly
    off the map gets weights that cancel and contributes zero."""
    h, w, _ = fmap.shape
    xf = torch.floor(xs).long()
    yf = torch.floor(ys).long()
    x0 = xf.clamp(0, w - 1)
    x1 = (xf + 1).clamp(0, w - 1)
    y0 = yf.clamp(0, h - 1)
    y1 = (yf + 1).clamp(0, h - 1)
    wa = ((x1 - xs) * (y1 - ys))[:, None]
    wb = ((x1 - xs) * (ys - y0))[:, None]
    wc = ((xs - x0) * (y1 - ys))[:, None]
    wd = ((xs - x0) * (ys - y0))[:, None]
    flat = fmap.reshape(h * w, -1)

    def at(y, x):
        return flat.index_select(0, y * w + x)

    return (at(y0, x0) * wa + at(y1, x0) * wb + at(y0, x1) * wc
            + at(y1, x1) * wd)


NUM_POINT = 5           # the centre and the 4 BEV edge midpoints
CODE_SIZE = 9           # [x y z w l h r vx vy]
FC_WIDTHS = (256, 256)  # SHARED_FC, CLS_FC, REG_FC of the reference configs


def box_sample_points(boxes: torch.Tensor) -> torch.Tensor:
    """(N, >= 7) boxes [x y z w l h .. r] -> (NUM_POINT * N, 3) points: the
    centre, then the front, back, left and right BEV edge midpoints in the
    reference's rotation sense (two_stage.py:51-76)."""
    cx, cy, z = boxes[:, 0], boxes[:, 1], boxes[:, 2]
    hw, hl = boxes[:, 3] / 2, boxes[:, 4] / 2
    r = boxes[:, -1]
    c, s = torch.cos(r), torch.sin(r)

    def mid(dx, dy):
        return torch.stack([cx + dx * c + dy * s, cy - dx * s + dy * c, z], 1)

    zero = 0 * hw
    return torch.cat([boxes[:, :3], mid(-hw, zero), mid(hw, zero),
                      mid(zero, -hl), mid(zero, hl)], dim=0)


class BEVFeatureExtractor(nn.Module):
    """bird_eye_view.py:10-60: the BEV map sampled at the points, the
    points' features side by side per box."""

    def __init__(self, pc_start: Tuple[float, float] = (-54.0, -54.0),
                 voxel_size: Tuple[float, float] = (0.075, 0.075),
                 out_stride: int = 8):
        super().__init__()
        self.pc_start = tuple(pc_start)
        self.voxel_size = tuple(voxel_size)
        self.out_stride = out_stride

    def forward(self, bev_nhwc: torch.Tensor,
                centers: torch.Tensor) -> torch.Tensor:
        """bev_nhwc (H, W, C) of one sample; centers (NUM_POINT * N, 3) as
        `box_sample_points` orders them -> (N, C * NUM_POINT)."""
        xs = ((centers[:, 0] - self.pc_start[0]) / self.voxel_size[0]
              / self.out_stride)
        ys = ((centers[:, 1] - self.pc_start[1]) / self.voxel_size[1]
              / self.out_stride)
        feats = bilinear_interpolate(bev_nhwc, xs, ys)
        return torch.cat(feats.chunk(NUM_POINT, dim=0), dim=1)


def _fc_stack(cin: int, widths: Sequence[int], out: int = 0,
              device=None) -> nn.Sequential:
    """[Conv1d(k=1, no bias), BN1d, ReLU] per width, an Identity in the
    place of the reference's Dropout after the first, and with `out` a
    final biased Conv1d (roi_head_template.py make_fc_layers)."""
    layers = []
    for i, c in enumerate(widths):
        layers += [nn.Conv1d(cin, c, 1, bias=False, device=device),
                   nn.BatchNorm1d(c, device=device), nn.ReLU()]
        if i == 0:
            layers.append(nn.Identity())
        cin = c
    if out:
        layers.append(nn.Conv1d(cin, out, 1, bias=True, device=device))
    return nn.Sequential(*layers)


def run_fc(seq: nn.Sequential, h: torch.Tensor) -> torch.Tensor:
    """A `_fc_stack` over (N, C) rows: the k=1 convs as Linear layers, the
    BatchNorms as flax's (`batch_norm_2d`)."""
    for mod in seq:
        if isinstance(mod, nn.Conv1d):
            h = F.linear(h, mod.weight[:, :, 0], mod.bias)
        elif isinstance(mod, nn.BatchNorm1d):
            h = batch_norm_2d(mod, h)
        else:
            h = mod(h)
    return h


class RoIHead(nn.Module):
    """roi_head.py:17-69: the shared FC stack, then separate cls / reg
    stacks ending in the iou-confidence and the box-refinement outputs,
    each stack FC_WIDTHS wide. Parameters are drawn on the CPU from
    `generator` with torch's default bounds."""

    def __init__(self, input_channels: int, device=None,
                 generator: torch.Generator = None):
        super().__init__()
        w = FC_WIDTHS
        self.shared_fc_layer = _fc_stack(input_channels, w, device=device)
        self.cls_layers = _fc_stack(w[-1], w, 1, device=device)
        self.reg_layers = _fc_stack(w[-1], w, CODE_SIZE, device=device)
        if generator is not None:
            with torch.no_grad():
                for mod in self.modules():
                    if isinstance(mod, nn.Conv1d):
                        bound = mod.weight.shape[1] ** -0.5
                        for p in (mod.weight, mod.bias):
                            if p is not None:
                                p.copy_(torch.empty(p.shape).uniform_(
                                    -bound, bound, generator=generator))

    def forward(self, roi_feats: torch.Tensor):
        """(R, C) -> (iou logits (R,), reg (R, CODE_SIZE))."""
        h = run_fc(self.shared_fc_layer, roi_feats)
        return run_fc(self.cls_layers, h)[:, 0], run_fc(self.reg_layers, h)


def second_stage_score(iou_logits: torch.Tensor,
                       first_scores: torch.Tensor) -> torch.Tensor:
    """two_stage.py:139: sqrt(sigmoid(iou) * roi score)."""
    return torch.sqrt(torch.sigmoid(iou_logits) * first_scores)


# the reference two-stage config (configs/waymo/voxelnet/two_stage/*.py)
ROI_SAMPLER_DEFAULTS = dict(
    ROI_PER_IMAGE=128, FG_RATIO=0.5, CLS_SCORE_TYPE="roi_iou",
    CLS_FG_THRESH=0.75, CLS_BG_THRESH=0.25, CLS_BG_THRESH_LO=0.1,
    HARD_BG_RATIO=0.8, REG_FG_THRESH=0.55)


def reorder_to_roi_layout(boxes_det3d):
    """[x y z w l h vx vy r] -> the roi layout [x y z w l h r vx vy]."""
    return boxes_det3d[:, [0, 1, 2, 3, 4, 5, 8, 6, 7]]


def roi_layout_to_det3d(boxes_roi):
    """Inverse of reorder_to_roi_layout."""
    return boxes_roi[..., [0, 1, 2, 3, 4, 5, 7, 8, 6]]


def _rotate_rows_z(rows, angle):
    """box_torch_ops.rotate_points_along_z in row form (det3d sense):
    rows[:, :2] rotated by `angle` per row."""
    c, s = np.cos(angle), np.sin(angle)
    x = rows[:, 0] * c + rows[:, 1] * s
    y = -rows[:, 0] * s + rows[:, 1] * c
    out = rows.copy()
    out[:, 0], out[:, 1] = x, y
    return out


def _subsample_rois(max_overlaps, cfg, rng):
    """proposal_target_layer.subsample_rois:137-180."""
    n_roi = cfg["ROI_PER_IMAGE"]
    fg_per_image = int(np.round(cfg["FG_RATIO"] * n_roi))
    fg_thresh = min(cfg["REG_FG_THRESH"], cfg["CLS_FG_THRESH"])
    fg = np.flatnonzero(max_overlaps >= fg_thresh)
    easy_bg = np.flatnonzero(max_overlaps < cfg["CLS_BG_THRESH_LO"])
    hard_bg = np.flatnonzero((max_overlaps < cfg["REG_FG_THRESH"])
                             & (max_overlaps >= cfg["CLS_BG_THRESH_LO"]))

    def sample_bg(k):
        if len(hard_bg) and len(easy_bg):
            nh = min(int(k * cfg["HARD_BG_RATIO"]), len(hard_bg))
            ne = k - nh
            return np.concatenate([
                hard_bg[rng.integers(0, len(hard_bg), nh)],
                easy_bg[rng.integers(0, len(easy_bg), ne)]])
        pool = hard_bg if len(hard_bg) else easy_bg
        return pool[rng.integers(0, len(pool), k)]

    if len(fg) and (len(easy_bg) + len(hard_bg)):
        nf = min(fg_per_image, len(fg))
        fg = fg[rng.permutation(len(fg))[:nf]]
        return np.concatenate([fg, sample_bg(n_roi - nf)])
    if len(fg):
        return fg[np.floor(rng.random(n_roi) * len(fg)).astype(int)]
    if len(easy_bg) + len(hard_bg):
        return sample_bg(n_roi)
    return np.zeros(0, np.int64)


def assign_roi_targets(rois, roi_scores, roi_labels, gt_boxes, gt_classes,
                       rng, cfg=None) -> Dict[str, np.ndarray]:
    """One sample's proposal-target assignment and canonical residual
    targets (proposal_target_layer.py:14-181, roi_head_template.py:43-86).
    rois (N, 9) in the roi layout; gt_boxes (M, 9) in det3d's. Returns
    arrays of ROI_PER_IMAGE rows: rois, sampled_inds (into the input rois),
    roi_scores, roi_labels, gt_of_rois (canonical targets), gt_iou,
    reg_mask, cls_labels (-1 where unused)."""
    cfg = {**ROI_SAMPLER_DEFAULTS, **(cfg or {})}
    n_out = cfg["ROI_PER_IMAGE"]
    gt_roi = reorder_to_roi_layout(np.asarray(gt_boxes, np.float64)) \
        if len(gt_boxes) else np.zeros((1, 9))

    if len(rois):
        iou = boxes_iou3d(rois[:, :7], gt_roi[:, :7])        # (N, M)
        max_overlaps = iou.max(axis=1) if iou.shape[1] else \
            np.zeros(len(rois))
        gt_assign = iou.argmax(axis=1) if iou.shape[1] else \
            np.zeros(len(rois), np.int64)
        sampled = _subsample_rois(max_overlaps, cfg, rng)
    else:
        sampled = np.zeros(0, np.int64)
        max_overlaps = np.zeros(0)
        gt_assign = np.zeros(0, np.int64)

    out = {
        "rois": np.zeros((n_out, 9), np.float32),
        "sampled_inds": np.zeros(n_out, np.int64),
        "roi_scores": np.zeros(n_out, np.float32),
        "roi_labels": np.zeros(n_out, np.int64),
        "gt_of_rois": np.zeros((n_out, 9), np.float32),
        "gt_iou": np.zeros(n_out, np.float32),
        "reg_mask": np.zeros(n_out, np.float32),
        "cls_labels": np.full(n_out, -1.0, np.float32),
    }
    k = min(len(sampled), n_out)
    if k == 0:
        return out
    sel = sampled[:k]
    r = rois[sel]
    ious = max_overlaps[sel]
    gts = gt_roi[gt_assign[sel]]

    # canonical residuals (roi_head_template.py:52-84)
    roi_ry = limit_period(r[:, 6], offset=0.5, period=2 * np.pi)
    tgt = gts.copy()
    tgt[:, :6] -= r[:, :6]
    tgt[:, 6] -= roi_ry
    tgt = _rotate_rows_z(tgt, -roi_ry)
    tgt[:, 7:9] -= r[:, 7:9]
    heading = tgt[:, 6] % (2 * np.pi)
    opp = (heading > np.pi * 0.5) & (heading < np.pi * 1.5)
    heading[opp] = (heading[opp] + np.pi) % (2 * np.pi)
    heading = np.where(heading > np.pi, heading - 2 * np.pi, heading)
    tgt[:, 6] = np.clip(heading, -np.pi / 2, np.pi / 2)

    # roi_iou soft classification labels (proposal_target_layer.py:51-64)
    fg = ious > cfg["CLS_FG_THRESH"]
    bg = ious < cfg["CLS_BG_THRESH"]
    soft = (ious - cfg["CLS_BG_THRESH"]) / (cfg["CLS_FG_THRESH"]
                                            - cfg["CLS_BG_THRESH"])
    cls_labels = np.where(fg, 1.0, np.where(bg, 0.0, soft))

    out["rois"][:k] = r
    out["sampled_inds"][:k] = sel
    out["roi_scores"][:k] = roi_scores[sel]
    out["roi_labels"][:k] = roi_labels[sel] + 1
    out["gt_of_rois"][:k] = tgt
    out["gt_iou"][:k] = ious
    out["reg_mask"][:k] = (ious > cfg["REG_FG_THRESH"]).astype(np.float32)
    out["cls_labels"][:k] = cls_labels
    return out


def generate_refined_boxes(rois: torch.Tensor,
                           reg: torch.Tensor) -> torch.Tensor:
    """Canonical refinement -> world boxes (roi_head_template.py
    generate_predicted_boxes:157-183); rois and reg (R, 9) in the roi
    layout. The rotation f_{+ry} inverts assign_roi_targets' f_{-ry}."""
    roi_ry = rois[:, 6]
    pred = reg + torch.cat([torch.zeros_like(rois[:, :3]), rois[:, 3:]], 1)
    c, s = torch.cos(roi_ry), torch.sin(roi_ry)
    x = pred[:, 0] * c + pred[:, 1] * s
    y = -pred[:, 0] * s + pred[:, 1] * c
    return torch.cat([(x + rois[:, 0])[:, None], (y + rois[:, 1])[:, None],
                      (pred[:, 2] + rois[:, 2])[:, None], pred[:, 3:]], 1)


def roi_losses(iou_logits: torch.Tensor, reg: torch.Tensor,
               cls_labels: torch.Tensor, reg_targets: torch.Tensor,
               reg_mask: torch.Tensor,
               code_weights: Sequence[float] = (1.0,) * 9,
               cls_weight: float = 1.0, reg_weight: float = 1.0):
    """roi_head_template.py:88-147: binary CE of the iou confidence against
    the soft labels (label -1 masked out), and the code-weighted L1 of the
    canonical residuals over the foreground count."""
    valid = (cls_labels >= 0).to(torch.float32)
    t = cls_labels.clamp(0.0, 1.0)
    bce = (torch.clamp_min(iou_logits, 0) - iou_logits * t
           + torch.log1p(torch.exp(-iou_logits.abs())))
    cls_loss = (bce * valid).sum() / torch.clamp_min(valid.sum(), 1.0)
    cw = torch.tensor(code_weights, dtype=reg.dtype, device=reg.device)
    l1 = (reg - reg_targets).abs() * cw
    reg_loss = (l1 * reg_mask[:, None]).sum() \
        / torch.clamp_min(reg_mask.sum(), 1.0)
    return cls_weight * cls_loss, reg_weight * reg_loss


class TwoStageRefinement(nn.Module):
    """The second stage on ONE sample's BEV map and its padded proposal set
    (two_stage.py:159-199 after the proposals): 5-point BEV pooling, the
    rois and their scores appended (the reference's add_box_param), the
    RoI head."""

    def __init__(self, bev_channels: int,
                 pc_start: Tuple[float, float] = (-54.0, -54.0),
                 voxel_size: Tuple[float, float] = (0.075, 0.075),
                 out_stride: int = 8, device=None,
                 generator: torch.Generator = None):
        super().__init__()
        self.bev_extractor = BEVFeatureExtractor(pc_start, voxel_size,
                                                 out_stride)
        self.roi_head = RoIHead(bev_channels * NUM_POINT + CODE_SIZE + 1,
                                device=device, generator=generator)

    def forward(self, bev_nhwc: torch.Tensor, rois: torch.Tensor,
                roi_scores: torch.Tensor):
        """bev_nhwc (H, W, C); rois (R, 9) in the roi layout; roi_scores
        (R,) -> (iou logits (R,), reg (R, CODE_SIZE))."""
        feats = self.bev_extractor(bev_nhwc, box_sample_points(rois[:, :7]))
        return self.roi_head(torch.cat([feats, rois, roi_scores[:, None]],
                                       dim=1))
