"""Plain PyTorch reference of LinK's CenterPoint-ELKv3 nuScenes training
step: the forward in train mode, CenterPoint's targets, its loss, the
gradients by autograd and one-cycle Adam's step.

Written from the published recipe (LinK detection/det3d: VoxelNet with
SpMiddleResNetFHDELKv3, RPN and CenterHead; `AssignLabel` with
out_size_factor 8, gaussian_overlap 0.1, min_radius 2, max_objs 500,
dense_reg 1; `FastFocalLoss` and the L1 `RegLoss` with the code weights
(1, 1, 1, 1, 1, 1, 0.2, 0.2, 1, 1) and weight 0.25, summed over the six
tasks; torchie's optimizer hook with grad_clip max_norm 35 and fastai's
OptimWrapper Adam with true weight decay 0.01, betas (0.85-0.95, 0.99))
over the det3d parameter names, which the port keeps too. The model's
forward is `centerpoint.Net`'s, with every norm normalizing by the batch's
own statistics (BatchNorm in training mode: the mean and the biased
variance over the real rows of a sparse level, over batch, height and
width of a dense map). The voxelization, the strided convs' output sets,
the kernel maps and the ELK aux blocks are worked out from the raw points
there; the targets here, from the boxes, in NumPy. Float32 throughout
(the caller sets `allow_tf32` False); `sparse.Precision` rounds the
products' operands for the control.

Departures from the published trainer, each of which leaves the three
checked steps' numbers as the published step computes them:
  * the norms' running statistics are not updated: a training-mode
    forward does not read them;
  * the learning rate and Adam's beta1 are given per step (the benchmark
    holds the one-cycle schedule at its peak, 1e-3 and 0.85);
  * the frames arrive augmented and without GT-AUG's pasted objects (the
    nuScenes object database is not at hand);
  * the gradient clip scales by max_norm / (norm + 1e-6) above max_norm,
    as `torch.nn.utils.clip_grad_norm_` does.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import centerpoint as C
from . import sparse as S

TASKS = (("car",), ("truck", "construction_vehicle"), ("bus", "trailer"),
         ("barrier",), ("motorcycle", "bicycle"),
         ("pedestrian", "traffic_cone"))
CLASSES = tuple(c for t in TASKS for c in t)
CODE_WEIGHTS = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2, 1.0, 1.0)
LOC_WEIGHT = 0.25
OUT_SIZE_FACTOR = 8
GAUSSIAN_OVERLAP = 0.1
MIN_RADIUS = 2
MAX_OBJS = 500


# ---------------------------------------------------------------- targets

def gaussian_radius(height: float, width: float, min_overlap: float) -> float:
    """det3d's center_utils.gaussian_radius (CornerNet's three cases, with
    its `(b + sqrt) / 2` for the second and third roots, as published)."""
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1 ** 2 - 4 * c1)) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2 ** 2 - 16 * c2)) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3 ** 2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)


def splat(hm: np.ndarray, cx: int, cy: int, radius: int) -> None:
    """A Gaussian of sigma (2 radius + 1) / 6 at cell (cx, cy) of the (H, W)
    map, the maximum kept (draw_umich_gaussian)."""
    d = 2 * radius + 1
    ys, xs = np.ogrid[-radius:radius + 1, -radius:radius + 1]
    g = np.exp(-(xs * xs + ys * ys) / (2 * (d / 6) ** 2))
    g[g < np.finfo(g.dtype).eps * g.max()] = 0
    h, w = hm.shape
    x0, x1 = max(cx - radius, 0), min(cx + radius + 1, w)
    y0, y1 = max(cy - radius, 0), min(cy + radius + 1, h)
    if x1 <= x0 or y1 <= y0:
        return
    win = g[y0 - cy + radius:y1 - cy + radius, x0 - cx + radius:x1 - cx + radius]
    np.maximum(hm[y0:y1, x0:x1], win, out=hm[y0:y1, x0:x1])


def targets(boxes: np.ndarray, classes: np.ndarray, cfg: Dict) -> List[Dict]:
    """Per task, one frame's targets: hm (H, W, C_t), and for its first
    MAX_OBJS boxes the centre cell `ind` (y W + x), `mask`, `cat` (the
    class within the task) and `box` (10,) [the centre's offset in its
    cell (2), z, log w, log l, log h, vx, vy, sin yaw, cos yaw]. boxes (N,
    9) [x y z w l h vx vy yaw], classes the nuScenes class names' indices
    (0-based, in `CLASSES`' order)."""
    vs, pc = cfg["voxel_size"], cfg["pc_range"]
    w_map = int(round((pc[3] - pc[0]) / vs[0])) // OUT_SIZE_FACTOR
    h_map = int(round((pc[4] - pc[1]) / vs[1])) // OUT_SIZE_FACTOR
    names = np.asarray(CLASSES)[classes]
    out = []
    for task in TASKS:
        sel = np.isin(names, task)
        tb, tn = boxes[sel], names[sel]
        hm = np.zeros((h_map, w_map, len(task)), np.float32)
        ind = np.zeros(MAX_OBJS, np.int64)
        mask = np.zeros(MAX_OBJS, np.float32)
        cat = np.zeros(MAX_OBJS, np.int64)
        box = np.zeros((MAX_OBJS, 10), np.float32)
        for k in range(min(len(tb), MAX_OBJS)):
            b = tb[k]
            w = b[3] / vs[0] / OUT_SIZE_FACTOR
            length = b[4] / vs[1] / OUT_SIZE_FACTOR
            if w <= 0 or length <= 0:
                continue
            radius = max(MIN_RADIUS, int(gaussian_radius(length, w,
                                                         GAUSSIAN_OVERLAP)))
            ct = np.array([(b[0] - pc[0]) / vs[0] / OUT_SIZE_FACTOR,
                           (b[1] - pc[1]) / vs[1] / OUT_SIZE_FACTOR],
                          np.float32)
            ci = ct.astype(np.int32)
            if not (0 <= ci[0] < w_map and 0 <= ci[1] < h_map):
                continue
            c = task.index(tn[k])
            splat(hm[:, :, c], int(ci[0]), int(ci[1]), radius)
            ind[k] = ci[1] * w_map + ci[0]
            mask[k] = 1
            cat[k] = c
            box[k] = np.concatenate([ct - ci, b[2:3], np.log(b[3:6]), b[6:8],
                                     [np.sin(b[8]), np.cos(b[8])]])
        out.append({"hm": hm, "ind": ind, "mask": mask, "cat": cat,
                    "box": box})
    return out


def stack_targets(frames: Sequence[List[Dict]], dev) -> List[Dict]:
    """Per task, the frames' targets stacked over the batch on `dev`."""
    return [{k: torch.as_tensor(np.stack([f[t][k] for f in frames]),
                                device=dev)
             for k in frames[0][t]} for t in range(len(TASKS))]


# ---------------------------------------------------------------- loss

def _at(fmap: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """(B, H, W, D) map -> (B, M, D) at the flat cells `ind` (B, M)."""
    b, h, w, d = fmap.shape
    return torch.gather(fmap.reshape(b, h * w, d), 1,
                        ind[..., None].expand(-1, -1, d))


def focal_loss(logits: torch.Tensor, tgt: Dict) -> torch.Tensor:
    """FastFocalLoss on the sigmoid clamped to [1e-4, 1 - 1e-4]."""
    out = torch.sigmoid(logits).clamp(1e-4, 1 - 1e-4)
    neg = (torch.log(1 - out) * out.square()
           * torch.pow(1 - tgt["hm"], 4)).sum()
    pos_pred = torch.gather(_at(out, tgt["ind"]), 2,
                            tgt["cat"][..., None])[..., 0]
    num_pos = tgt["mask"].sum()
    pos = (torch.log(pos_pred) * (1 - pos_pred).square() * tgt["mask"]).sum()
    if float(num_pos) == 0:
        return -neg
    return -(pos + neg) / num_pos


def reg_loss(maps: torch.Tensor, tgt: Dict) -> torch.Tensor:
    """RegLoss: the masked L1 of each of the 10 box channels over the
    number of boxes (+ 1e-4)."""
    m = tgt["mask"][..., None]
    loss = (_at(maps, tgt["ind"]) * m - tgt["box"] * m).abs()
    return (loss / (m.sum() + 1e-4)).sum((0, 1))


def loss_of(heads: List[Dict[str, torch.Tensor]], tgts: List[Dict]):
    """The sum over the tasks of hm loss + 0.25 x the code-weighted box
    loss."""
    cw = None
    total = 0.0
    for pd, tgt in zip(heads, tgts):
        maps = torch.cat([pd["reg"], pd["height"], pd["dim"], pd["vel"],
                          pd["rot"]], -1)
        box = reg_loss(maps, tgt)
        if cw is None:
            cw = torch.tensor(CODE_WEIGHTS, device=box.device)
        total = total + focal_loss(pd["hm"], tgt) + LOC_WEIGHT * (box
                                                                 * cw).sum()
    return total


# ---------------------------------------------------------------- model

class TrainNet(C.Net):
    """`centerpoint.Net` with every BatchNorm in training mode."""

    def bn(self, name: str, x: torch.Tensor, eps: float, dims=(0,)):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mean = x.mean(dims, keepdim=True)
        var = (x - mean).square().mean(dims, keepdim=True)
        return ((x - mean) * torch.rsqrt(var + eps)
                * self.p[name + ".weight"].view(shape)
                + self.p[name + ".bias"].view(shape))


def frames_input(frames: Sequence[np.ndarray], cfg: Dict, dev):
    """The frames' points voxelized (at the voxel cap) as one batch:
    coords (N, 4) (x, y, z, b) and mean features (N, 5)."""
    cs, fs = [], []
    for b, p in enumerate(frames):
        c, f = C.voxelize(p, cfg["voxel_size"], cfg["pc_range"],
                          cfg["max_points_in_voxel"], cfg["max_voxels"])
        cs.append(np.concatenate([c, np.full((len(c), 1), b)], 1))
        fs.append(f)
    return (torch.as_tensor(np.concatenate(cs), device=dev),
            torch.as_tensor(np.concatenate(fs), device=dev))


def is_parameter(name: str) -> bool:
    return not name.endswith((".running_mean", ".running_var"))


class Adam:
    """One-cycle Adam's step at a given lr and beta1: the gradients clipped
    to a global norm of `clip`, Adam (beta2 0.99, eps 1e-8, bias-corrected
    by the step count), and the decay `wd` x the parameter added to the
    update."""

    def __init__(self, params: Dict[str, torch.Tensor], wd: float = 0.01,
                 clip: float = 35.0, b2: float = 0.99, eps: float = 1e-8):
        self.p, self.wd, self.clip, self.b2, self.eps = params, wd, clip, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float, b1: float):
        norm = torch.sqrt(sum(g.double().square().sum()
                              for g in grads.values())).float()
        scale = (self.clip / (norm + 1e-6)) if float(norm) > self.clip else 1.0
        t = self.count + 1
        for k, p in self.p.items():
            g = grads[k] * scale
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (self.m[k] / (1 - b1 ** t)) / (
                torch.sqrt(self.v[k] / (1 - self.b2 ** t)) + self.eps)
            p.sub_(lr * (u + self.wd * p))
        self.count = t


def train_steps(params: Dict[str, torch.Tensor], batches: Sequence[Dict],
                cfg: Dict, lr: float, b1: float, wd: float, clip: float,
                prec: S.Precision = S.EXACT):
    """One step on each of `batches` (dicts of `points`, a list of each
    frame's (N, 5) points, and `targets`, `stack_targets`' list) from
    `params` (parameters and the norms' buffers, det3d names). Returns the
    losses, the first step's gradients and the parameters after the steps
    (float32 copies)."""
    leaves = {k: v.detach().clone().float().requires_grad_(is_parameter(k))
              for k, v in params.items()}
    trainable = {k: v for k, v in leaves.items() if v.requires_grad}
    opt = Adam(trainable, wd=wd, clip=clip)
    net = TrainNet(leaves, prec=prec, grid=cfg["grid"], block=cfg["block_sz"],
                   r=cfg["elk_r"])
    dev = next(iter(params.values())).device
    losses, first = [], None
    for b in batches:
        coords, feats = frames_input(b["points"], cfg, dev)
        loss = loss_of(net.forward(coords, feats, len(b["points"])),
                       b["targets"])
        grads = torch.autograd.grad(loss, list(trainable.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(trainable.items(), grads)}
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads, lr, b1)
        del loss, grads, coords, feats
    return losses, first, {k: v.detach() for k, v in trainable.items()}
