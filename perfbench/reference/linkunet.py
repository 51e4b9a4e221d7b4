"""Plain PyTorch reference of LinK's SemanticKITTI U-Net (ELKUNet) and its
training step.

Written from the published model (LinK, segmentation/core/models/
semantic_kitti/linkunet.py: a MinkUNet whose four encoder levels each add
a linear large-kernel branch), not from the port: the parameters carry the
reference `state_dict` names, which the port keeps too, so one set of
weights serves both. Every sparse operation runs on the real rows only
(`sparse.py`), and the kernel maps, the strided coordinate sets and the
ELK aux blocks are worked out here from the voxel coordinates.

ELK block (cos_x basis, block s = 3 x the level's stride, window r = 2):
  f = LayerNorm(Linear(x));  p = Linear(xyz) * alpha  (no bias)
  m = [f cos p, f sin p, f p]                (3C channels)
  A = the mean of m over the voxels whose aux cell (floor(xyz / s))
      lies in the 2 x 2 x 2 window {a, a + 1}^3 of the voxel's own cell a
  y = ReLU(LN(A_0 cos p + A_1 sin p + A_2 - f p) + LN(conv3(x)))
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import sparse as S

BN_EPS = 1e-5
LN_EPS = 1e-6


class Level:
    """The coordinates of one stride level and their lookup."""

    def __init__(self, coords: torch.Tensor, stride: int):
        self.coords = coords
        self.stride = stride
        self.lookup = S.Lookup(coords)
        self.subm = None          # the 3^3 submanifold pairs, built once

    def subm_pairs(self):
        if self.subm is None:
            self.subm = S.conv_pairs(self.coords, self.coords,
                                     S.kernel_offsets(3, self.stride),
                                     self.lookup)
        return self.subm


def down_level(level: Level) -> Tuple[Level, list]:
    """The stride-2 level above `level` (coords floored to multiples of
    2 x stride) and the kernel-2 stride-2 conv's pairs (tap order x-major,
    offsets {0, stride}^3)."""
    s2 = level.stride * 2
    c = level.coords.clone()
    c[:, :3] = torch.div(c[:, :3], s2, rounding_mode="floor") * s2
    coarse, _ = S.unique_rows(c)
    up = Level(coarse, s2)
    pairs = S.conv_pairs(level.coords, coarse, S.kernel_offsets(2, level.stride),
                         level.lookup)
    return up, pairs


class Plan:
    """Every level's coordinates and the strided convs' pairs of a batch."""

    def __init__(self, coords: torch.Tensor, levels: int = 5):
        self.levels: List[Level] = [Level(coords, 1)]
        self.down_pairs = []
        for _ in range(levels - 1):
            up, pairs = down_level(self.levels[-1])
            self.levels.append(up)
            self.down_pairs.append(pairs)


class Net:
    """The model's forward over a parameter dict (the port's state_dict
    names); `prec` rounds every matrix product's operands."""

    def __init__(self, params: Dict[str, torch.Tensor], r: int = 2, s: int = 3,
                 prec: S.Precision = S.EXACT):
        self.p = params
        self.r, self.s = r, s
        self.prec = prec

    def bn(self, name, x):
        return S.batch_norm_train(x, self.p[name + ".weight"],
                                  self.p[name + ".bias"], BN_EPS)

    def subm(self, name, x, level: Level):
        return S.apply_pairs(x, self.p[name], level.subm_pairs(),
                             x.shape[0], self.prec)

    def linear(self, name, x, bias=True):
        y = self.prec.mm(x, self.p[name + ".weight"].T)
        return y + self.p[name + ".bias"] if bias else y

    def residual(self, name, x, level):
        y = torch.relu(self.bn(name + ".net.1",
                               self.subm(name + ".net.0.kernel", x, level)))
        y = self.bn(name + ".net.4", self.subm(name + ".net.3.kernel", y, level))
        if name + ".downsample.0.kernel" in self.p:
            sc = self.bn(name + ".downsample.1",
                         self.prec.mm(x, self.p[name + ".downsample.0.kernel"]))
        else:
            sc = x
        return torch.relu(y + sc)

    def elk(self, name, x, level: Level):
        p = self.p
        f = S.layer_norm(self.linear(name + ".pre_mix.0", x, bias=False),
                         p[name + ".pre_mix.1.weight"],
                         p[name + ".pre_mix.1.bias"], LN_EPS)
        local = self.subm(name + ".local_mix.0.kernel", x, level)
        xyz = level.coords[:, :3].to(x.dtype)
        pw = self.prec.mm(xyz, p[name + ".pos_weight.0.weight"].T) * p[
            name + ".alpha"]
        f_lin = f * pw
        mod = torch.cat([f * torch.cos(pw), f * torch.sin(pw), f_lin], 1)
        # aux cells and the windows over them
        blk = self.s * level.stride
        cell = level.coords.clone()
        cell[:, :3] = torch.div(cell[:, :3], blk, rounding_mode="floor")
        cells, which = S.unique_rows(cell)
        n_cell = cells.shape[0]
        sums = mod.new_zeros((n_cell, mod.shape[1])).index_add(0, which, mod)
        cnt = torch.zeros(n_cell, dtype=mod.dtype, device=mod.device
                          ).index_add(0, which, torch.ones_like(mod[:, 0]))
        lk = S.Lookup(cells)
        win_sum = torch.zeros_like(sums)
        win_cnt = torch.zeros_like(cnt)
        for o in S.kernel_offsets(self.r, 1).to(cells.device):
            q = cells.clone()
            q[:, :3] += o
            idx = lk(q)
            hit = torch.nonzero(idx >= 0).squeeze(1)
            win_sum = win_sum.index_add(0, hit, sums.index_select(0, idx[hit]))
            win_cnt = win_cnt.index_add(0, hit, cnt.index_select(0, idx[hit]))
        agg = (win_sum / win_cnt[:, None]).index_select(0, which)
        c = x.shape[1]
        new = (agg[:, :c] * torch.cos(pw) + agg[:, c:2 * c] * torch.sin(pw)
               + (agg[:, 2 * c:] - f_lin))
        new = S.layer_norm(new, p[name + ".norm.weight"], p[name + ".norm.bias"],
                           LN_EPS)
        loc = S.layer_norm(local, p[name + ".norm_local.weight"],
                           p[name + ".norm_local.bias"], LN_EPS)
        return torch.relu(new + loc)

    def forward(self, feats: torch.Tensor, plan: Plan) -> torch.Tensor:
        lv = plan.levels
        x = torch.relu(self.bn("stem.1", self.subm("stem.0.kernel", feats,
                                                     lv[0])))
        x = torch.relu(self.bn("stem.4", self.subm("stem.3.kernel", x, lv[0])))
        skips = [x]
        for l in range(1, 5):
            x0 = S.apply_pairs(x, self.p[f"down{l}.0.net.0.kernel"],
                               plan.down_pairs[l - 1], lv[l].coords.shape[0],
                               self.prec)
            x0 = torch.relu(self.bn(f"down{l}.0.net.1", x0))
            y = self.residual(f"stage{l}.0", x0, lv[l])
            y = self.residual(f"stage{l}.1", y, lv[l])
            y = self.bn(f"stage{l}_tail.1",
                        self.subm(f"stage{l}_tail.0.kernel", y, lv[l]))
            k = self.elk(f"elk{l}", x0, lv[l])
            k = self.bn(f"elk{l}_tail.1",
                        self.subm(f"elk{l}_tail.0.kernel", k, lv[l]))
            x = torch.relu(y + k)
            skips.append(x)
        y = skips[4]
        for u in range(1, 5):
            fine = 4 - u
            y = S.apply_pairs(y, self.p[f"up{u}.0.net.0.kernel"],
                              plan.down_pairs[fine], lv[fine].coords.shape[0],
                              self.prec, transposed=True)
            y = torch.relu(self.bn(f"up{u}.0.net.1", y))
            y = torch.cat([y, skips[fine]], 1)
            y = self.residual(f"up{u}.1.0", y, lv[fine])
            y = self.residual(f"up{u}.1.1", y, lv[fine])
        return self.linear("classifier.0", y)


def lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovasz extension w.r.t. sorted errors (Berman et
    al., lovasz_losses.py)."""
    gts = gt_sorted.sum()
    intersection = gts - gt_sorted.cumsum(0)
    union = gts + (1 - gt_sorted).cumsum(0)
    jaccard = 1.0 - intersection / union
    return torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])


def seg_loss(logits: torch.Tensor, labels: torch.Tensor,
             ignore: int = 0) -> torch.Tensor:
    """Cross-entropy (ignore label 0) + Lovasz-softmax over the present
    classes, as the reference trainer sums them."""
    keep = labels != ignore
    lg, lb = logits[keep], labels[keep]
    ce = torch.nn.functional.cross_entropy(lg, lb)
    prob = torch.softmax(lg, 1)
    losses = []
    for c in range(logits.shape[1]):
        fg = (lb == c).to(prob.dtype)
        if fg.sum() == 0:
            continue
        err = (fg - prob[:, c]).abs()
        err_sorted, perm = torch.sort(err, descending=True)
        losses.append(torch.dot(err_sorted, lovasz_grad(fg[perm])))
    return ce + torch.stack(losses).mean()


def train_steps(params: Dict[str, torch.Tensor], batches, steps: int,
                lr: float, momentum: float, weight_decay: float,
                prec: S.Precision = S.EXACT):
    """`steps` SGD (Nesterov) steps from `params` on `batches` (each a dict
    of coords (N, 4), feats (N, 4), labels (N,) tensors). Returns the
    losses, the first step's gradients and the parameters after the
    steps (float32 copies)."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    opt = torch.optim.SGD(list(leaves.values()), lr=lr, momentum=momentum,
                          weight_decay=weight_decay, nesterov=True)
    net = Net(leaves, prec=prec)
    losses, first_grad = [], None
    for b in batches[:steps]:
        plan = Plan(b["coords"])
        opt.zero_grad(set_to_none=True)
        loss = seg_loss(net.forward(b["feats"], plan), b["labels"])
        loss.backward()
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {k: v.grad.detach().clone() for k, v in leaves.items()}
        opt.step()
        del plan, loss
    return losses, first_grad, {k: v.detach() for k, v in leaves.items()}


def param_spec(cr: float = 1.0, in_channels: int = 4,
               num_classes: int = 20) -> List[Tuple[str, tuple, float]]:
    """(name, shape, init) of every parameter: init > 0 is the bound of a
    uniform draw (the reference's 1/sqrt(fan) rules), init <= 0 the
    constant -init (norm scales 1, shifts 0, alpha 1)."""
    c = int(cr * 64)
    spec = []

    def conv(name, k, ci, co, transposed=False):
        fan = (co if transposed else ci) * k
        shape = (k, ci, co) if k > 1 else (ci, co)
        spec.append((name, shape, fan ** -0.5))

    def norm(name, n):
        spec.append((name + ".weight", (n,), -1.0))
        spec.append((name + ".bias", (n,), -0.0))

    def residual(name, ci, co):
        conv(name + ".net.0.kernel", 27, ci, co)
        norm(name + ".net.1", co)
        conv(name + ".net.3.kernel", 27, co, co)
        norm(name + ".net.4", co)
        if ci != co:
            conv(name + ".downsample.0.kernel", 1, ci, co)
            norm(name + ".downsample.1", co)

    conv("stem.0.kernel", 27, in_channels, c)
    norm("stem.1", c)
    conv("stem.3.kernel", 27, c, c)
    norm("stem.4", c)
    for l in range(1, 5):
        conv(f"down{l}.0.net.0.kernel", 8, c, c)
        norm(f"down{l}.0.net.1", c)
        residual(f"stage{l}.0", c, c)
        residual(f"stage{l}.1", c, c)
        conv(f"stage{l}_tail.0.kernel", 27, c, c)
        norm(f"stage{l}_tail.1", c)
        spec.append((f"elk{l}.alpha", (1, c), -1.0))
        spec.append((f"elk{l}.pre_mix.0.weight", (c, c), c ** -0.5))
        norm(f"elk{l}.pre_mix.1", c)
        conv(f"elk{l}.local_mix.0.kernel", 27, c, c)
        spec.append((f"elk{l}.pos_weight.0.weight", (c, 3), 3 ** -0.5))
        norm(f"elk{l}.norm", c)
        norm(f"elk{l}.norm_local", c)
        conv(f"elk{l}_tail.0.kernel", 27, c, c)
        norm(f"elk{l}_tail.1", c)
    for u in range(1, 5):
        conv(f"up{u}.0.net.0.kernel", 8, c, c, transposed=True)
        norm(f"up{u}.0.net.1", c)
        residual(f"up{u}.1.0", 2 * c, c)
        residual(f"up{u}.1.1", c, c)
    spec.append(("classifier.0.weight", (num_classes, c), c ** -0.5))
    spec.append(("classifier.0.bias", (num_classes,), c ** -0.5))
    return spec
