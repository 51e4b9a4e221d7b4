"""Plain PyTorch reference of LinK's CenterPoint-ELKv3 nuScenes detector at
inference, with its double-flip test-time fusion, box decode and rotated
NMS.

Written from the published model (LinK detection/det3d: VoxelNet with
VoxelFeatureExtractorV3, SpMiddleResNetFHDELKv3, RPN, CenterHead;
test-time DoubleFlip and the CenterHead's fused decode; rotate_nms) over a
parameter dict with the det3d `state_dict` names, which the port keeps
too. Everything the port derives is worked out here again from the raw
points: the hard voxelization (the mean of each 0.075 x 0.075 x 0.2 m
voxel's first 10 points, the first 160,000 voxels by first appearance),
the three flipped clouds, the strided convs' output sets (spconv: every
output cell an input reaches through the kernel), the kernel maps and the
ELK aux blocks. Computes in float32 (or rounds the products' operands, for
the control: `sparse.Precision`).

ELK block of the detector (TSELK, cos basis, block 7, window 3, det
channel grouping): f = LayerNorm(Linear(x)); p = Linear(xyz)[:, :C/2]
tiled twice; m = [f cos p, f sin p]; A = the mean of m over the voxels
whose aux cell (floor(xyz / 7)) lies in the 3^3 window centred on the
voxel's cell; y = ReLU(LN(A_0 cos p + A_1 sin p) + LN(SubM3(x))).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import sparse as S

PLANES = (16, 32, 64, 128)
BN_EPS_DET = 1e-3           # backbone and RPN
BN_EPS_HEAD = 1e-5
LN_EPS = 1e-6
HEADS = (("reg", 2), ("height", 1), ("dim", 3), ("rot", 2), ("vel", 2))
TASK_CLASSES = (1, 2, 2, 1, 2, 2)


# ---------------------------------------------------------------- inputs

def voxelize(points: np.ndarray, voxel_size, pc_range, max_points: int,
             max_voxels: int) -> Tuple[np.ndarray, np.ndarray]:
    """Hard voxelization: (coords (V, 3) int (x, y, z), mean features
    (V, F)) of the first `max_voxels` voxels by first appearance, each
    over its first `max_points` points."""
    vs = np.asarray(voxel_size, np.float32)
    lo = np.asarray(pc_range[:3], np.float32)
    grid = np.round((np.asarray(pc_range[3:6], np.float32) - lo) / vs
                    ).astype(np.int64)
    c = np.floor((points[:, :3] - lo) / vs).astype(np.int64)
    keep = ((c >= 0) & (c < grid)).all(1)
    pts, c = points[keep], c[keep]
    key = (c[:, 2] * grid[1] + c[:, 1]) * grid[0] + c[:, 0]
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")           # by first appearance
    rank = np.empty(len(uniq), np.int64)
    rank[order] = np.arange(len(uniq))
    vid = rank[inv.reshape(-1)]
    # each point's rank inside its voxel, in point order
    srt = np.argsort(vid, kind="stable")
    counts = np.bincount(vid, minlength=len(uniq))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.empty(len(vid), np.int64)
    within[srt] = np.arange(len(vid)) - starts[vid[srt]]
    n_vox = min(len(uniq), max_voxels)
    sel = (vid < n_vox) & (within < max_points)
    sums = np.zeros((n_vox, points.shape[1]), np.float64)
    np.add.at(sums, vid[sel], pts[sel].astype(np.float64))
    cnt = np.bincount(vid[sel], minlength=n_vox)
    feats = (sums / np.maximum(cnt, 1)[:, None]).astype(np.float32)
    coords = c[first[order[:n_vox]]]
    return coords, feats


def flips(points: np.ndarray) -> List[np.ndarray]:
    """[original, y-flip, x-flip, xy-flip]: the published DoubleFlip."""
    out = [points]
    for fy, fx in ((True, False), (False, True), (True, True)):
        p = points.copy()
        if fy:
            p[:, 1] = -p[:, 1]
        if fx:
            p[:, 0] = -p[:, 0]
        out.append(p)
    return out


def batch_inputs(points: np.ndarray, cfg: Dict, dev):
    """The four flips voxelized as one batch: coords (N, 4) (x, y, z, b)
    and features (N, 5) on `dev`."""
    cs, fs = [], []
    for b, p in enumerate(flips(points)):
        c, f = voxelize(p, cfg["voxel_size"], cfg["pc_range"],
                        cfg["max_points_in_voxel"], cfg["max_voxels"])
        cs.append(np.concatenate([c, np.full((len(c), 1), b)], 1))
        fs.append(f)
    return (torch.as_tensor(np.concatenate(cs), device=dev),
            torch.as_tensor(np.concatenate(fs), device=dev))


# ---------------------------------------------------------------- model

class Net:
    """The detector's forward in eval mode over a parameter dict (det3d
    names, under `backbone.`, `neck.`, `bbox_head.`). With `collect` the
    norms normalize with the batch's own statistics and record them as
    running statistics into `params` (the benchmark's data-dependent
    initialisation of a random model)."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 prec: S.Precision = S.EXACT, collect: bool = False,
                 grid=(1440, 1440, 40), block: int = 7, r: int = 3):
        self.p = params
        self.prec = prec
        self.collect = collect
        self.grid = grid
        self.block, self.r = block, r

    # norms
    def bn(self, name: str, x: torch.Tensor, eps: float, dims=(0,)):
        p = self.p
        if self.collect:
            mean = x.mean(dims)
            var = x.var(dims, unbiased=False)
            p[name + ".running_mean"] = mean.detach().clone()
            p[name + ".running_var"] = var.detach().clone()
        shape = (1, -1) + (1,) * (x.dim() - 2) if x.dim() > 2 else (1, -1)
        rm = p[name + ".running_mean"].view(shape)
        rv = p[name + ".running_var"].view(shape)
        return ((x - rm) * torch.rsqrt(rv + eps)
                * p[name + ".weight"].view(shape) + p[name + ".bias"].view(shape))

    # sparse convs over (coords (N, 4), feats)
    def subm(self, name: str, coords, x, lookup, bias=False):
        w = self.p[name + ".weight"]             # (Co, kz, ky, kx, Ci)
        out = x.new_zeros((x.shape[0], w.shape[0]))
        for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
            q = coords.clone()
            q[:, 0] += dx
            q[:, 1] += dy
            q[:, 2] += dz
            idx = lookup(q)
            j = torch.nonzero(idx >= 0).squeeze(1)
            if j.numel():
                out = out.index_add(0, j, self.prec.mm(
                    x.index_select(0, idx[j]), w[:, dz + 1, dy + 1, dx + 1].T))
        if bias:
            out = out + self.p[name + ".bias"]
        return out

    def spconv(self, name: str, coords, x, lookup, k, st, pad, shape):
        """Strided spconv: output set, then out[j] = sum_t W_t x[j s - p + t]."""
        from ..scenes.audit import spconv_out
        out_c, out_shape = spconv_out(coords, k, st, pad, shape)
        w = self.p[name + ".weight"]
        out = x.new_zeros((out_c.shape[0], w.shape[0]))
        s = torch.tensor(st, device=coords.device)
        pd = torch.tensor(pad, device=coords.device)
        for tx, ty, tz in itertools.product(*(range(v) for v in k)):
            q = out_c.clone()
            q[:, :3] = out_c[:, :3] * s - pd + torch.tensor(
                (tx, ty, tz), device=coords.device)
            idx = lookup(q)
            j = torch.nonzero(idx >= 0).squeeze(1)
            if j.numel():
                out = out.index_add(0, j, self.prec.mm(
                    x.index_select(0, idx[j]), w[:, tz, ty, tx].T))
        return out_c, out, out_shape

    def elk(self, name: str, coords, x, lookup):
        p = self.p
        c = x.shape[1]
        f = S.layer_norm(self.prec.mm(x, p[name + ".pre_mix.0.weight"].T),
                         p[name + ".pre_mix.1.weight"],
                         p[name + ".pre_mix.1.bias"], LN_EPS)
        local = S.apply_pairs(x, p[name + ".local_mix.0.kernel"],
                              S.conv_pairs(coords, coords,
                                           S.kernel_offsets(3, 1), lookup),
                              x.shape[0], self.prec)
        pw = self.prec.mm(coords[:, :3].to(x.dtype),
                          p[name + ".pos_weight.0.weight"].T)
        pw = torch.cat([pw[:, :c // 2], pw[:, :c // 2]], 1)
        mod = torch.cat([f * torch.cos(pw), f * torch.sin(pw)], 1)
        cell = coords.clone()
        cell[:, :3] = torch.div(cell[:, :3], self.block, rounding_mode="floor")
        cells, which = S.unique_rows(cell)
        n = cells.shape[0]
        sums = mod.new_zeros((n, mod.shape[1])).index_add(0, which, mod)
        cnt = torch.zeros(n, dtype=mod.dtype, device=mod.device).index_add(
            0, which, torch.ones_like(mod[:, 0]))
        lk = S.Lookup(cells)
        ws, wc = torch.zeros_like(sums), torch.zeros_like(cnt)
        for o in S.kernel_offsets(self.r, 1).to(cells.device):
            q = cells.clone()
            q[:, :3] += o
            idx = lk(q)
            hit = torch.nonzero(idx >= 0).squeeze(1)
            ws = ws.index_add(0, hit, sums.index_select(0, idx[hit]))
            wc = wc.index_add(0, hit, cnt.index_select(0, idx[hit]))
        agg = (ws / wc[:, None]).index_select(0, which)
        new = agg[:, :c] * torch.cos(pw) + agg[:, c:] * torch.sin(pw)
        new = S.layer_norm(new, p[name + ".norm.weight"], p[name + ".norm.bias"],
                           LN_EPS)
        loc = S.layer_norm(local, p[name + ".norm_local.weight"],
                           p[name + ".norm_local.bias"], LN_EPS)
        return torch.relu(new + loc)

    def backbone(self, coords, feats, batch: int) -> torch.Tensor:
        b = "backbone."
        shape = (self.grid[0], self.grid[1], self.grid[2] + 1)
        lk = S.Lookup(coords)
        x = torch.relu(self.bn(b + "conv_input.1", self.subm(
            b + "conv_input.0", coords, feats, lk), BN_EPS_DET))
        for lvl in range(1, 5):
            if lvl > 1:
                pad = (1, 1, 1) if lvl < 4 else (1, 1, 0)
                coords, x, shape = self.spconv(b + f"down{lvl}.0", coords, x,
                                               lk, (3, 3, 3), (2, 2, 2), pad,
                                               shape)
                x = torch.relu(self.bn(b + f"down{lvl}.1", x, BN_EPS_DET))
                lk = S.Lookup(coords)
            y = x
            for blk in (0, 1):
                n = b + f"conv{lvl}.{blk}."
                h = torch.relu(self.bn(n + "bn1", self.subm(
                    n + "conv1", coords, y, lk, bias=True), BN_EPS_DET))
                h = self.bn(n + "bn2", self.subm(n + "conv2", coords, h, lk,
                                                 bias=True), BN_EPS_DET)
                y = torch.relu(h + y)
            y = self.bn(b + f"conv{lvl}_tail.1", self.subm(
                b + f"conv{lvl}_tail.0", coords, y, lk), BN_EPS_DET)
            k = self.elk(b + f"elk{lvl}", coords, x, lk)
            k = self.bn(b + f"elk{lvl}_tail.1", self.subm(
                b + f"elk{lvl}_tail.0", coords, k, lk), BN_EPS_DET)
            x = torch.relu(y + k)
        coords, x, shape = self.spconv(b + "extra_conv.0", coords, x, lk,
                                       (1, 1, 3), (1, 1, 2), (0, 0, 0), shape)
        x = torch.relu(self.bn(b + "extra_conv.1", x, BN_EPS_DET))
        w, h, d = shape
        c = x.shape[1]
        dense = x.new_zeros((batch, d, h, w, c))
        dense[coords[:, 3], coords[:, 2], coords[:, 1], coords[:, 0]] = x
        return dense.permute(0, 4, 1, 2, 3).reshape(batch, c * d, h, w)

    def conv2d(self, name, x, stride=1, padding=0, bias=False):
        w = self.p[name + ".weight"]
        xr, wr = self.prec.round(x), self.prec.round(w)
        b = self.p[name + ".bias"] if bias else None
        return F.conv2d(xr, wr, b, stride, padding)

    def neck(self, x):
        n = "neck."
        ups = []
        for i, (cout, stride) in enumerate(((128, 1), (256, 2))):
            h = F.pad(x, (1, 1, 1, 1))
            h = torch.relu(self.bn(f"{n}blocks.{i}.2", self.conv2d(
                f"{n}blocks.{i}.1", h, stride), BN_EPS_DET, (0, 2, 3)))
            for j in range(5):
                conv, norm = 4 + 3 * j, 5 + 3 * j
                h = torch.relu(self.bn(f"{n}blocks.{i}.{norm}", self.conv2d(
                    f"{n}blocks.{i}.{conv}", h, 1, 1), BN_EPS_DET, (0, 2, 3)))
            x = h
            if i == 0:
                u = self.conv2d(f"{n}deblocks.0.0", h)
            else:
                w = self.prec.round(self.p[f"{n}deblocks.1.0.weight"])
                u = F.conv_transpose2d(self.prec.round(h), w, None, 2)
            ups.append(torch.relu(self.bn(f"{n}deblocks.{i}.1", u, BN_EPS_DET,
                                          (0, 2, 3))))
        return torch.cat(ups, 1)

    def head(self, x) -> List[Dict[str, torch.Tensor]]:
        n = "bbox_head."
        h = torch.relu(self.bn(n + "shared_conv.1", self.conv2d(
            n + "shared_conv.0", x, 1, 1, True), BN_EPS_HEAD, (0, 2, 3)))
        out = []
        for t, ncls in enumerate(TASK_CLASSES):
            d = {}
            for br, _ in HEADS + (("hm", ncls),):
                m = f"{n}tasks.{t}.{br}."
                g = torch.relu(self.bn(m + "1", self.conv2d(
                    m + "0", h, 1, 1, True), BN_EPS_HEAD, (0, 2, 3)))
                d[br] = self.conv2d(m + "3", g, 1, 1, True).permute(0, 2, 3, 1)
            out.append(d)
        return out

    def forward(self, coords, feats, batch: int):
        return self.head(self.neck(self.backbone(coords, feats, batch)))


def param_spec() -> List[Tuple[str, tuple, float]]:
    """(name, shape, init) of every parameter and norm buffer: init > 0 the
    bound of a uniform draw (spconv's 1/sqrt(Ci K), torch's 1/sqrt(fan_in)
    for the dense convs and their biases), init <= 0 the constant -init
    (norm scales 1, shifts 0; running statistics 0 / 1 until collected);
    the heatmaps' final bias -2.19 ("const" entries)."""
    spec = []

    def norm(name, n):
        spec.extend([(name + ".weight", (n,), -1.0), (name + ".bias", (n,), -0.0),
                     (name + ".running_mean", (n,), -0.0),
                     (name + ".running_var", (n,), -1.0)])

    def sp(name, ci, co, k=(3, 3, 3), bias=False):
        kx, ky, kz = k
        bound = (ci * kx * ky * kz) ** -0.5
        spec.append((name + ".weight", (co, kz, ky, kx, ci), bound))
        if bias:
            spec.append((name + ".bias", (co,), bound))

    b = "backbone."
    sp(b + "conv_input.0", 5, 16)
    norm(b + "conv_input.1", 16)
    for lvl, c in enumerate(PLANES, start=1):
        if lvl > 1:
            sp(b + f"down{lvl}.0", PLANES[lvl - 2], c)
            norm(b + f"down{lvl}.1", c)
        for blk in (0, 1):
            n = b + f"conv{lvl}.{blk}."
            sp(n + "conv1", c, c, bias=True)
            norm(n + "bn1", c)
            sp(n + "conv2", c, c, bias=True)
            norm(n + "bn2", c)
        sp(b + f"conv{lvl}_tail.0", c, c)
        norm(b + f"conv{lvl}_tail.1", c)
        e = b + f"elk{lvl}."
        spec.append((e + "pre_mix.0.weight", (c, c), c ** -0.5))
        spec.extend([(e + "pre_mix.1.weight", (c,), -1.0),
                     (e + "pre_mix.1.bias", (c,), -0.0)])
        spec.append((e + "local_mix.0.kernel", (27, c, c), (27 * c) ** -0.5))
        spec.append((e + "pos_weight.0.weight", (c, 3), 3 ** -0.5))
        for ln in ("norm", "norm_local"):
            spec.extend([(e + ln + ".weight", (c,), -1.0),
                         (e + ln + ".bias", (c,), -0.0)])
        sp(b + f"elk{lvl}_tail.0", c, c)
        norm(b + f"elk{lvl}_tail.1", c)
    sp(b + "extra_conv.0", 128, 128, k=(1, 1, 3))
    norm(b + "extra_conv.1", 128)

    def conv(name, ci, co, k, bias=False, const_bias=None):
        bound = (ci * k * k) ** -0.5
        spec.append((name + ".weight", (co, ci, k, k), bound))
        if const_bias is not None:
            spec.append((name + ".bias", (co,), -const_bias))
        elif bias:
            spec.append((name + ".bias", (co,), bound))

    n = "neck."
    for i, (ci, co) in enumerate(((256, 128), (128, 256))):
        conv(f"{n}blocks.{i}.1", ci, co, 3)
        norm(f"{n}blocks.{i}.2", co)
        for j in range(5):
            conv(f"{n}blocks.{i}.{4 + 3 * j}", co, co, 3)
            norm(f"{n}blocks.{i}.{5 + 3 * j}", co)
    conv(f"{n}deblocks.0.0", 128, 256, 1)
    norm(f"{n}deblocks.0.1", 256)
    # ConvTranspose2d weight (in, out, k, k); torch's fan_in is out * k * k
    spec.append((f"{n}deblocks.1.0.weight", (256, 256, 2, 2),
                 (256 * 4) ** -0.5))
    norm(f"{n}deblocks.1.1", 256)
    h = "bbox_head."
    conv(h + "shared_conv.0", 512, 64, 3, bias=True)
    norm(h + "shared_conv.1", 64)
    for t, ncls in enumerate(TASK_CLASSES):
        for br, co in HEADS + (("hm", ncls),):
            m = f"{h}tasks.{t}.{br}."
            conv(m + "0", 64, 64, 3, bias=True)
            norm(m + "1", 64)
            conv(m + "3", 64, co, 3, bias=br != "hm",
                 const_bias=2.19 if br == "hm" else None)
    return spec


# ---------------------------------------------------------------- decode

def fuse_double_flip(pd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The published double-flip fusion of a batch of 4 NHWC maps
    [original, y-flip, x-flip, xy-flip]: each flipped map is flipped back
    (y-flip along H, x-flip along W), the heatmap averaged after the
    sigmoid, the sizes after the exp; the offsets, the rotation's sine and
    cosine and the velocity have their flipped components mirrored."""
    def back(v):
        return [v[0], torch.flip(v[1], (0,)), torch.flip(v[2], (1,)),
                torch.flip(v[3], (0, 1))]

    out = {"hm": torch.stack(back(torch.sigmoid(pd["hm"]))).mean(0),
           "height": torch.stack(back(pd["height"])).mean(0),
           "dim": torch.stack(back(torch.exp(pd["dim"]))).mean(0)}
    reg = back(pd["reg"])
    reg = [reg[0], torch.stack([reg[1][..., 0], 1 - reg[1][..., 1]], -1),
           torch.stack([1 - reg[2][..., 0], reg[2][..., 1]], -1),
           1 - reg[3]]
    out["reg"] = torch.stack(reg).mean(0)
    rot = back(pd["rot"])          # channels (sin, cos)
    sgn = torch.tensor([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0], [-1.0, -1.0]],
                       device=pd["rot"].device)
    out["rot"] = torch.stack([r * sgn[i] for i, r in enumerate(rot)]).mean(0)
    vel = back(pd["vel"])
    vsg = torch.tensor([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0], [-1.0, -1.0]],
                       device=pd["vel"].device)
    out["vel"] = torch.stack([v * vsg[i] for i, v in enumerate(vel)]).mean(0)
    return out


def decode(heads: List[Dict[str, torch.Tensor]], test_cfg: Dict):
    """Per task of one frame's fused maps: boxes (H*W, 9) [x y z w l h vx
    vy rot], scores, labels (global class ids) and the valid mask (score
    above the threshold, centre inside the post-centre range)."""
    out, offset = [], 0
    pc, vs = test_cfg["pc_range"], test_cfg["voxel_size"]
    osf = test_cfg["out_size_factor"]
    post = torch.tensor(test_cfg["post_center_limit_range"])
    for t, pd in enumerate(heads):
        f = fuse_double_flip({k: v.float() for k, v in pd.items()})
        h, w, c = f["hm"].shape
        dev = f["hm"].device
        ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                                torch.arange(w, device=dev, dtype=torch.float32),
                                indexing="ij")
        x = ((xs + f["reg"][..., 0]) * osf * vs[0] + pc[0]).reshape(-1, 1)
        y = ((ys + f["reg"][..., 1]) * osf * vs[1] + pc[1]).reshape(-1, 1)
        rot = torch.atan2(f["rot"][..., 0], f["rot"][..., 1]).reshape(-1, 1)
        boxes = torch.cat([x, y, f["height"].reshape(-1, 1),
                           f["dim"].reshape(-1, 3), f["vel"].reshape(-1, 2),
                           rot], 1)
        scores, labels = f["hm"].reshape(-1, c).max(1)
        p = post.to(dev)
        ok = ((boxes[:, :3] >= p[:3]).all(1) & (boxes[:, :3] <= p[3:]).all(1)
              & (scores > test_cfg["score_threshold"]))
        out.append((boxes, scores, labels + offset, ok))
        offset += c
    return out


def bev_corners(b: torch.Tensor) -> torch.Tensor:
    """(N, 5) [x y w l r] -> (N, 4, 2) corners, counter-clockwise, the
    template (+-w/2, +-l/2) turned by R(-r) (det3d's rotation_2d)."""
    hw, hl = b[:, 2] / 2, b[:, 3] / 2
    tx = torch.stack([-hw, hw, hw, -hw], 1)
    ty = torch.stack([-hl, -hl, hl, hl], 1)
    c, s = torch.cos(b[:, 4])[:, None], torch.sin(b[:, 4])[:, None]
    return torch.stack([c * tx + s * ty + b[:, None, 0],
                        -s * tx + c * ty + b[:, None, 1]], -1)


def _clip(poly: torch.Tensor, n: torch.Tensor, a: torch.Tensor,
          b: torch.Tensor):
    """Sutherland-Hodgman: the (P, M, 2) polygons with n valid vertices
    each, clipped by the half-plane left of the edge a -> b (P, 2)."""
    P, M, _ = poly.shape
    ex, ey = (b - a)[:, None, 0], (b - a)[:, None, 1]
    side = ex * (poly[..., 1] - a[:, None, 1]) - ey * (poly[..., 0]
                                                        - a[:, None, 0])
    idx = torch.arange(M, device=poly.device)[None].expand(P, M)
    valid = idx < n[:, None]
    nxt = torch.where(idx + 1 < n[:, None], idx + 1, torch.zeros_like(idx))
    q = torch.gather(poly, 1, nxt[..., None].expand(P, M, 2))
    sq = torch.gather(side, 1, nxt)
    inside, qin = side >= 0, sq >= 0
    t = side / torch.where((side - sq).abs() < 1e-30,
                           torch.full_like(side, 1e-30), side - sq)
    cross = poly + t[..., None] * (q - poly)
    # each vertex emits itself if inside, then the crossing if the edge
    # to the next vertex crosses the line
    emit_self = valid & inside
    emit_cross = valid & (inside != qin)
    cand = torch.stack([poly, cross], 2).reshape(P, 2 * M, 2)
    keep = torch.stack([emit_self, emit_cross], 2).reshape(P, 2 * M)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    out = torch.gather(cand, 1, order[..., None].expand(P, 2 * M, 2))
    return out[:, :M + 4], keep.sum(1)


def pair_iou(ca: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """IoU of BEV rectangles given as corners, pairwise over the rows of
    ca and cb (P, 4, 2): the intersection polygon by clipping a with b's
    four edges."""
    P = ca.shape[0]
    poly = torch.cat([ca, ca.new_zeros((P, 8, 2))], 1)
    n = torch.full((P,), 4, dtype=torch.long, device=ca.device)
    for e in range(4):
        poly, n = _clip(poly, n, cb[:, e], cb[:, (e + 1) % 4])
        poly = poly[:, :12]
        n = n.clamp(max=12)
    idx = torch.arange(12, device=ca.device)[None]
    valid = idx < n[:, None]
    nxt = torch.where(idx + 1 < n[:, None], idx + 1, torch.zeros_like(idx))
    q = torch.gather(poly, 1, nxt[..., None].expand(P, 12, 2))
    cr = poly[..., 0] * q[..., 1] - poly[..., 1] * q[..., 0]
    inter = 0.5 * (cr * valid).sum(1).abs()

    def area(c):
        return 0.5 * (c[:, :, 0] * c.roll(-1, 1)[:, :, 1]
                      - c[:, :, 1] * c.roll(-1, 1)[:, :, 0]).sum(1).abs()

    return inter / (area(ca) + area(cb) - inter).clamp(min=1e-12)


def rotated_nms(boxes: torch.Tensor, scores: torch.Tensor,
                valid: torch.Tensor, thresh: float, max_keep: int,
                chunk: int = 200_000) -> torch.Tensor:
    """Greedy NMS by descending score (ties: the lower index first): a
    valid candidate is kept unless a kept one overlaps it by IoU >
    thresh; at most max_keep kept. boxes (N, 5) [x y w l r]. Returns the
    keep mask in input order."""
    n = boxes.shape[0]
    corners = bev_corners(boxes.double())
    ii, jj = torch.triu_indices(n, n, 1, device=boxes.device)
    over = torch.zeros((n, n), dtype=torch.bool, device=boxes.device)
    for a in range(0, ii.numel(), chunk):
        i, j = ii[a:a + chunk], jj[a:a + chunk]
        # circles that do not meet cannot overlap
        r = 0.5 * torch.hypot(boxes[:, 2], boxes[:, 3]).double()
        near = torch.hypot(boxes[i, 0] - boxes[j, 0], boxes[i, 1]
                           - boxes[j, 1]).double() <= r[i] + r[j]
        i, j = i[near], j[near]
        if i.numel():
            ov = pair_iou(corners[i], corners[j]) > thresh
            over[i[ov], j[ov]] = True
    over = over | over.T
    key = torch.where(valid, scores, torch.full_like(scores, -math.inf))
    order = torch.sort(-key, stable=True).indices.tolist()
    keep = torch.zeros(n, dtype=torch.bool)
    over_c = over.cpu()
    valid_c = valid.cpu()
    suppressed = torch.zeros(n, dtype=torch.bool)
    kept = 0
    for i in order:
        if not valid_c[i] or suppressed[i]:
            continue
        keep[i] = True
        kept += 1
        if kept == max_keep:
            break
        suppressed |= over_c[i]
    return keep.to(boxes.device)


def candidates(task_out, pre: int):
    """The top `pre` rows by masked score (stable: ties by the lower
    index): (boxes, scores, labels, valid)."""
    boxes, scores, labels, ok = task_out
    key = torch.where(ok, scores, torch.full_like(scores, -math.inf))
    idx = torch.sort(key, descending=True, stable=True).indices[:pre]
    return boxes[idx], scores[idx], labels[idx], ok[idx]
