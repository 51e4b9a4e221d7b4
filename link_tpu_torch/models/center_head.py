"""CenterHead: CenterPoint multi-task detection head, its losses and box
decode.

PyTorch counterpart of `link_tpu/models/center_head.py` (reference
detection/det3d/models/bbox_heads/center_head.py:67-446 and
losses/centernet_loss.py:6-62): the head (with `dcn_head=True` a
DCNSepHead per task, `models/dcn.py`; off in every published LinK
config), the training loss (`center_head_loss`: FastFocal on the heatmaps
+ weight * code-weighted masked L1 on the boxes), the decode
(with the fuse of double-flip TTA, `double_flip_fuse`), and the rotated
NMS on the device (`device_nms`, through the `rotated_nms` kernel). Six task
groups over the nuScenes classes; per task a SepHead with branches reg(2) /
height(1) / dim(3) / rot(2) / vel(2) / hm(C), each Conv3x3 + BN + ReLU ->
Conv3x3 (hm's final bias -2.19). Module layout and `state_dict` keys follow the
reference (`shared_conv.0.weight`, `tasks.0.reg.3.bias`, ...). As in the
JAX package the head returns per-task dicts of NHWC maps: the convs run
NCHW and `SepHead.forward` is the one place that permutes, so the losses,
`assign_label`'s hm (H, W, C) and the decode all read channels last. The
decode runs in float32 whatever the compute dtype.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from ..ops.kernels import rotated_nms
from .rpn import _DTYPES, run_dense

HEAD_NORM = dict(eps=1e-5, momentum=0.1)
CODE_WEIGHTS = (1.0,) * 6 + (0.2, 0.2, 1.0, 1.0)
NUSC_TASKS = (("car",), ("truck", "construction_vehicle"),
              ("bus", "trailer"), ("barrier",), ("motorcycle", "bicycle"),
              ("pedestrian", "traffic_cone"))
COMMON_HEADS = (("reg", (2, 2)), ("height", (1, 2)), ("dim", (3, 2)),
                ("rot", (2, 2)), ("vel", (2, 2)))


def head_branch(cin: int, out_channels: int, num_conv: int,
                head_conv: int = 64, final_kernel: int = 3,
                init_bias: float = None, device=None) -> nn.Sequential:
    """(num_conv - 1) x [Conv + BN + ReLU] then the final biased conv."""
    layers = []
    c = cin
    for _ in range(num_conv - 1):
        layers += [nn.Conv2d(c, head_conv, final_kernel,
                             padding=final_kernel // 2, bias=True,
                             device=device),
                   nn.BatchNorm2d(head_conv, **HEAD_NORM, device=device),
                   nn.ReLU()]
        c = head_conv
    final = nn.Conv2d(c, out_channels, final_kernel,
                      padding=final_kernel // 2, bias=True, device=device)
    with torch.no_grad():
        if init_bias is not None:
            final.bias.fill_(init_bias)
        else:
            final.bias.zero_()
    return nn.Sequential(*layers, final)


class SepHead(nn.Module):
    """The branches of COMMON_HEADS and, with `with_hm`, the heatmap (the
    DCN head's task_head has no hm: its cls_head makes it)."""

    def __init__(self, cin: int, num_cls: int, num_hm_conv: int = 2,
                 init_bias: float = -2.19, with_hm: bool = True,
                 device=None):
        super().__init__()
        self.names = [n for n, _ in COMMON_HEADS] + (["hm"] if with_hm
                                                     else [])
        for name, (ch, ncv) in COMMON_HEADS:
            self.add_module(name, head_branch(cin, ch, ncv, device=device))
        if with_hm:
            self.hm = head_branch(cin, num_cls, num_hm_conv,
                                  init_bias=init_bias, device=device)

    def forward(self, h: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {n: run_dense(getattr(self, n), h).permute(0, 2, 3, 1)
                for n in self.names}


class CenterHead(nn.Module):

    def __init__(self, in_channels: int = 512,
                 tasks: Tuple[Tuple[str, ...], ...] = NUSC_TASKS,
                 share_conv_channel: int = 64, num_hm_conv: int = 2,
                 init_bias: float = -2.19, dcn_head: bool = False,
                 dtype: str = "float32", device="cuda"):
        super().__init__()
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        self.dtype = _DTYPES[dtype]
        self.dcn_head = dcn_head
        self.num_classes = [len(t) for t in tasks]
        self.shared_conv = nn.Sequential(
            nn.Conv2d(in_channels, share_conv_channel, 3, padding=1,
                      bias=True, device=device),
            nn.BatchNorm2d(share_conv_channel, **HEAD_NORM, device=device),
            nn.ReLU())
        if dcn_head:
            # reference center_head.py:221-238: a DCNSepHead per task
            from .dcn import DCNSepHead
            self.tasks = nn.ModuleList([
                DCNSepHead(share_conv_channel, len(t), init_bias=init_bias,
                           device=device) for t in tasks])
        else:
            self.tasks = nn.ModuleList([
                SepHead(share_conv_channel, len(t), num_hm_conv, init_bias,
                        device=device) for t in tasks])

    def forward(self, x: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        """x: (B, C, H, W) -> per-task dicts of (B, H, W, c) maps."""
        h = run_dense(self.shared_conv, x.to(self.dtype))
        return [task(h) for task in self.tasks]


def _gather_feat(fmap: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """fmap (B, H*W, C), ind (B, M) int64 -> (B, M, C)."""
    return torch.gather(fmap, 1, ind[..., None].expand(-1, -1, fmap.shape[2]))


def fast_focal_loss(out: torch.Tensor, target: torch.Tensor,
                    ind: torch.Tensor, mask: torch.Tensor,
                    cat: torch.Tensor) -> torch.Tensor:
    """CornerNet focal loss (centernet_loss.py:26-54). out / target
    (B, H, W, C), out already sigmoid-clamped; ind / mask / cat (B, M). The
    positive count is float32, as in both references."""
    gt = torch.pow(1 - target, 4)
    neg_loss = torch.sum(torch.log(1 - out) * out.square() * gt)
    b, h, w, c = out.shape
    pos_pix = _gather_feat(out.reshape(b, h * w, c), ind)       # (B, M, C)
    pos_pred = torch.gather(pos_pix, 2, cat[..., None])[..., 0]
    m = mask.to(torch.float32)
    num_pos = m.sum()
    pos_loss = torch.sum(torch.log(torch.clamp_min(pos_pred, 1e-12))
                         * (1 - pos_pred).square() * m)
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / torch.clamp_min(num_pos, 1.0))


def reg_loss(output: torch.Tensor, mask: torch.Tensor, ind: torch.Tensor,
             target: torch.Tensor) -> torch.Tensor:
    """Masked per-channel L1 (centernet_loss.py:6-24). output (B, H, W, D),
    target (B, M, D); returns the (D,) per-channel loss."""
    b, h, w, d = output.shape
    pred = _gather_feat(output.reshape(b, h * w, d), ind)       # (B, M, D)
    m = mask.to(torch.float32)[..., None]
    loss = torch.abs(pred * m - target * m)
    loss = loss / (m.sum() + 1e-4)
    return loss.sum(dim=(0, 1))


_CODE_WEIGHTS: Dict = {}


def _code_weights(code_weights, device: torch.device) -> torch.Tensor:
    """The code weights as a float32 tensor on `device`, copied there once
    per process and not on every step (a pageable host copy a task)."""
    key = (tuple(float(w) for w in code_weights), str(device))
    if key not in _CODE_WEIGHTS:
        _CODE_WEIGHTS[key] = torch.tensor(key[0], dtype=torch.float32,
                                          device=device)
    return _CODE_WEIGHTS[key]


def center_head_loss(preds: List[Dict[str, torch.Tensor]], example: Dict,
                     weight: float = 0.25, code_weights=CODE_WEIGHTS):
    """center_head.py:252-293. `preds` the head's per-task NHWC maps;
    `example` per-task stacked targets (`det_pipeline.det_targets`): hm[t]
    (B, H, W, C_t), anno_box[t] (B, M, 10), ind / mask / cat[t] (B, M).
    Returns (loss, logs) with logs {hm_loss_t, loc_loss_t, loss}.

    The maps are taken in float32 whatever the compute dtype, as the
    decode takes them. In bfloat16, 1 - 1e-4 rounds to 1, so the clamp
    would let a saturated heatmap logit through to log(1 - 1) = -inf (the
    JAX package's loss computes in the maps' dtype and does so; seen on
    full-size driving frames at initialization)."""
    total = 0.0
    logs = {}
    for t, pd in enumerate(preds):
        pd = {k: v.float() for k, v in pd.items()}
        hm = torch.clamp(torch.sigmoid(pd["hm"]), 1e-4, 1 - 1e-4)
        hm_loss = fast_focal_loss(hm, example["hm"][t], example["ind"][t],
                                  example["mask"][t], example["cat"][t])
        anno = torch.cat([pd["reg"], pd["height"], pd["dim"], pd["vel"],
                          pd["rot"]], dim=-1)
        box_loss = reg_loss(anno, example["mask"][t], example["ind"][t],
                            example["anno_box"][t])
        loc_loss = torch.sum(box_loss * _code_weights(code_weights,
                                                      box_loss.device))
        total = total + hm_loss + weight * loc_loss
        logs[f"hm_loss_{t}"] = hm_loss
        logs[f"loc_loss_{t}"] = loc_loss
    logs["loss"] = total
    return total, logs


def double_flip_fuse(pd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fuse the maps of a batch ordered in groups of 4, [original, y-flip,
    x-flip, xy-flip] (link_tpu/models/center_head.py:170-220; reference
    center_head.py:320-416). NHWC maps: group 1 is flipped back along H
    (y), group 2 along W (x), group 3 along both; hm is averaged after the
    sigmoid and dim after the exp, reg, rot and vel are sign-corrected,
    then each of the four is averaged. Returns maps of batch B / 4."""
    b4, h, w, _ = pd["hm"].shape
    b = b4 // 4

    def regroup(v):
        v = v.reshape(b, 4, h, w, v.shape[-1])
        return torch.stack([v[:, 0], torch.flip(v[:, 1], dims=(1,)),
                            torch.flip(v[:, 2], dims=(2,)),
                            torch.flip(v[:, 3], dims=(1, 2))], dim=1)

    out = {"hm": regroup(torch.sigmoid(pd["hm"])).mean(1),
           "height": regroup(pd["height"]).mean(1),
           "dim": regroup(torch.exp(pd["dim"])).mean(1)}
    reg = regroup(pd["reg"])
    reg[:, 1, ..., 1] = 1 - reg[:, 1, ..., 1]
    reg[:, 2, ..., 0] = 1 - reg[:, 2, ..., 0]
    reg[:, 3, ..., 0] = 1 - reg[:, 3, ..., 0]
    reg[:, 3, ..., 1] = 1 - reg[:, 3, ..., 1]
    out["reg"] = reg.mean(1)

    rot = regroup(pd["rot"])
    rots, rotc = rot[..., 0:1].clone(), rot[..., 1:2].clone()
    rotc[:, 1] *= -1
    rots[:, 2] *= -1
    rots[:, 3] *= -1
    rotc[:, 3] *= -1
    out["rot"] = torch.cat([rots.mean(1), rotc.mean(1)], -1)

    if "vel" in pd:
        vel = regroup(pd["vel"])
        vel[:, 1, ..., 1] *= -1
        vel[:, 2, ..., 0] *= -1
        vel[:, 3] *= -1
        out["vel"] = vel.mean(1)
    return out


def decode_boxes(preds: List[Dict[str, torch.Tensor]], test_cfg: Dict,
                 num_classes: Sequence[int], double_flip: bool = False):
    """center_head.py:296-446 decode without NMS (link_tpu/models/
    center_head.py:223-273): per task (boxes (B, H*W, 9)
    [x y z w l h vx vy rot], scores (B, H*W), labels (B, H*W) int32 with
    global class offsets, mask (B, H*W) = score above the threshold and
    centre inside the post-centre range). With `double_flip` the batch is
    groups of 4 flipped inputs, fused first (`double_flip_fuse`), and B is
    the number of groups. Decodes in float32."""
    out = []
    pc_range = test_cfg["pc_range"]
    voxel_size = test_cfg["voxel_size"]
    osf = test_cfg["out_size_factor"]
    score_thr = test_cfg["score_threshold"]
    class_offset = 0
    for t, pd in enumerate(preds):
        pd = {k: v.float() for k, v in pd.items()}
        if double_flip:
            pd = double_flip_fuse(pd)
            hm, dim_map = pd["hm"], pd["dim"]
        else:
            hm, dim_map = torch.sigmoid(pd["hm"]), torch.exp(pd["dim"])
        b, h, w, c = hm.shape
        dev = hm.device
        post = torch.tensor(test_cfg["post_center_limit_range"],
                            dtype=torch.float32, device=dev)
        dim = dim_map.reshape(b, h * w, 3)
        rot = torch.atan2(pd["rot"][..., 0:1], pd["rot"][..., 1:2]).reshape(
            b, h * w, 1)
        reg = pd["reg"].reshape(b, h * w, 2)
        hei = pd["height"].reshape(b, h * w, 1)
        vel = pd["vel"].reshape(b, h * w, 2)
        hm_flat = hm.reshape(b, h * w, c)
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                             device=dev),
                                torch.arange(w, dtype=torch.float32,
                                             device=dev), indexing="ij")
        xs = xs.reshape(1, h * w, 1) + reg[:, :, 0:1]
        ys = ys.reshape(1, h * w, 1) + reg[:, :, 1:2]
        xs = xs * osf * voxel_size[0] + pc_range[0]
        ys = ys * osf * voxel_size[1] + pc_range[1]
        boxes = torch.cat([xs, ys, hei, dim, vel, rot], dim=2)
        scores, labels = hm_flat.max(dim=-1)
        in_range = ((boxes[..., :3] >= post[:3]).all(-1)
                    & (boxes[..., :3] <= post[3:6]).all(-1))
        mask = (scores > score_thr) & in_range
        out.append((boxes, scores, (labels + class_offset).to(torch.int32),
                    mask))
        class_offset += num_classes[t]
    return out


def _candidates(task_outs, test_cfg: Dict):
    """The `nms_candidates` of every task and batch row at once, stacked
    (T * B rows, task-major): one stable sort of the masked scores for the
    frame. Returns (boxes (T*B, k, 9), scores (T*B, k) with -inf where
    invalid, labels, valid) and B; every task has the same H*W."""
    pre = int(test_cfg.get("nms_pre_max_size", 1000))
    boxes, scores, labels, mask = (torch.stack(x) for x in zip(*task_outs))
    t, b, n, c = boxes.shape
    k = min(pre, n)
    sc = torch.where(mask, scores, torch.full_like(scores, -float("inf")))
    top_sc, top_idx = torch.sort(sc.reshape(t * b, n), dim=1,
                                 descending=True, stable=True)
    # the scores contiguous, as the kernel takes them
    top_sc, top_idx = top_sc[:, :k].contiguous(), top_idx[:, :k]
    return (torch.gather(boxes.reshape(t * b, n, c), 1,
                         top_idx[..., None].expand(t * b, k, c)),
            top_sc, torch.gather(labels.reshape(t * b, n), 1, top_idx),
            torch.gather(mask.reshape(t * b, n), 1, top_idx)), b


def nms_candidates(task_outs, test_cfg: Dict):
    """Per task of `decode_boxes` outputs, the top k = min(nms_pre_max_size,
    H*W) candidates by masked score, by a stable sort (ties by the lower
    index, as jax.lax.top_k): (boxes (B, k, 9), scores (B, k) with -inf
    where invalid, labels (B, k), valid (B, k))."""
    stacked, b = _candidates(task_outs, test_cfg)
    return [tuple(x[t * b:(t + 1) * b] for x in stacked)
            for t in range(len(task_outs))]


def device_nms(task_outs, test_cfg: Dict):
    """Rotated NMS on the device over `decode_boxes` outputs
    (link_tpu/models/center_head.py:276-311): the `nms_candidates` of every
    task and batch row, then ONE `rotated_nms` call over all of them, the
    sets stacked (T * B, k) on their BEV columns [x y w l r], the keep
    capped at nms_post_max_size. Returns per task (boxes (B, k, 9), scores
    (B, k) zeroed where invalid, labels, keep mask): the tuple contract of
    `decode_boxes`, with the mask now the post-NMS keep. Nothing leaves the
    device."""
    post = int(test_cfg.get("nms_post_max_size", 83))
    th = float(test_cfg.get("nms_iou_threshold", 0.2))
    (bx, sc, lb, vm), b = _candidates(task_outs, test_cfg)
    # [x y w l r] by slices: a list index would copy itself from the host,
    # and the copy waits for the stream
    bev = torch.cat([bx[..., 0:2], bx[..., 3:5], bx[..., 8:9]], -1)
    keep = rotated_nms(bev, sc, vm, th, post)
    sc = torch.where(vm, sc, torch.zeros_like(sc))
    return [tuple(x[t * b:(t + 1) * b] for x in (bx, sc, lb, keep))
            for t in range(len(task_outs))]
