"""The work a model needs, counted from its inputs alone.

A sparse conv's products are 2 x (valid kernel-map pairs) x Ci x Co: only
the (input row, output row, tap) triples whose input row exists, worked
out here from the coordinates, not the K x capacity that a padded kernel
map holds. Its bytes are the input features, the weights, the output
features and two int32 a pair, each counted once. A dense conv or linear
is counted from its shapes. Elementwise work (norms, activations, the ELK
block's modulation and window sums, the loss) is not counted.

Each entry is one call: (name, role, K, pairs, rows_in, rows_out, Ci, Co,
sparse, itemsize); role is "fwd", "dgrad" (feature gradient) or "wgrad"
(weight gradient), and `sparse` marks the convs that run through a
kernel map (the gather / window conv kernels), as against 1x1 convs and
linears, which are plain matrix products.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from ..reference import sparse as S


class Call(NamedTuple):
    name: str
    role: str
    k: int
    pairs: int
    rows_in: int
    rows_out: int
    ci: int
    co: int
    sparse: bool
    itemsize: int

    @property
    def flops(self) -> float:
        return 2.0 * self.pairs * self.ci * self.co

    @property
    def bytes(self) -> float:
        """Operands read once and results written once."""
        feat_in = self.rows_in * self.ci * self.itemsize
        feat_out = self.rows_out * self.co * self.itemsize
        w = self.k * self.ci * self.co * self.itemsize
        idx = 8 * self.pairs if self.sparse else 0
        if self.role == "fwd":
            return feat_in + w + feat_out + idx
        if self.role == "dgrad":      # reads g (rows_out) and W, writes d_in
            return feat_out + w + feat_in + idx
        return feat_in + feat_out + w + idx   # wgrad: feats, g -> dW


def with_backward(fwd: List[Call], no_dgrad=()) -> List[Call]:
    """The forward calls and, for each, its weight gradient and (unless its
    input needs none: names in `no_dgrad`) its feature gradient."""
    out = list(fwd)
    for c in fwd:
        if c.name not in no_dgrad:
            out.append(c._replace(role="dgrad"))
        out.append(c._replace(role="wgrad"))
    return out


def subm_pairs(coords: torch.Tensor, size, stride: int,
               lookup: S.Lookup = None) -> int:
    """Valid pairs of a submanifold conv (output rows = input rows)."""
    pairs = S.conv_pairs(coords, coords, S.kernel_offsets(size, stride),
                         lookup)
    return int(sum(int(i.numel()) for i, _ in pairs))


def linkunet_levels(coords: torch.Tensor, levels: int = 5):
    """(rows, 3^3 submanifold pairs) of each stride level of a batch whose
    level-0 coords (N, 4) are given; the strided levels floor to multiples
    of 2^l, as the kernel-2 stride-2 convs do."""
    out = []
    c = coords.to(torch.int64)
    for l in range(levels):
        s = 1 << l
        if l:
            d = c.clone()
            d[:, :3] = torch.div(d[:, :3], s, rounding_mode="floor") * s
            c, _ = S.unique_rows(d)
        out.append((int(c.shape[0]), subm_pairs(c, 3, s)))
    return out


def linkunet_train_calls(coords: torch.Tensor, cfg: Dict) -> List[Call]:
    """Every matrix product of one ELKUNet training step (forward, feature
    and weight gradients) on a batch with these level-0 coords."""
    c = int(cfg["cr"] * 64)
    ncls = cfg["num_classes"]
    cin = cfg["in_channels"]
    isz = 4
    lv = linkunet_levels(coords)
    calls = []

    def sub(name, l, ci, co):
        n, p = lv[l]
        calls.append(Call(name, "fwd", 27, p, n, n, ci, co, True, isz))

    def dense(name, l, ci, co, rows=None):
        n = lv[l][0] if rows is None else rows
        calls.append(Call(name, "fwd", 1, n, n, n, ci, co, False, isz))

    sub("stem.0", 0, cin, c)
    sub("stem.3", 0, c, c)
    for l in range(1, 5):
        n_fine, n_coarse = lv[l - 1][0], lv[l][0]
        # every fine row reaches exactly one coarse row through one tap
        calls.append(Call(f"down{l}", "fwd", 8, n_fine, n_fine, n_coarse, c,
                          c, True, isz))
        for r in (f"stage{l}.0", f"stage{l}.1"):
            sub(r + ".net.0", l, c, c)
            sub(r + ".net.3", l, c, c)
        sub(f"stage{l}_tail", l, c, c)
        dense(f"elk{l}.pre_mix", l, c, c)
        sub(f"elk{l}.local_mix", l, c, c)
        dense(f"elk{l}.pos_weight", l, 3, c)
        sub(f"elk{l}_tail", l, c, c)
    for u in range(1, 5):
        f = 4 - u
        n_fine, n_coarse = lv[f][0], lv[f + 1][0]
        calls.append(Call(f"up{u}.deconv", "fwd", 8, n_fine, n_coarse, n_fine,
                          c, c, True, isz))
        sub(f"up{u}.1.0.net.0", f, 2 * c, c)
        sub(f"up{u}.1.0.net.3", f, c, c)
        dense(f"up{u}.1.0.downsample", f, 2 * c, c)
        sub(f"up{u}.1.1.net.0", f, c, c)
        sub(f"up{u}.1.1.net.3", f, c, c)
    dense("classifier", 0, c, ncls)
    no_dgrad = ("stem.0",) + tuple(f"elk{l}.pos_weight" for l in range(1, 5))
    return with_backward(calls, no_dgrad)


def totals(calls: List[Call], peak_flops: float, peak_bytes: float) -> Dict:
    """Products of all calls; products, bytes and least seconds of the
    sparse convs (each call's larger of products / peak and bytes / peak
    bandwidth)."""
    sp = [c for c in calls if c.sparse]
    return {"flops": sum(c.flops for c in calls),
            "conv_flops": sum(c.flops for c in sp),
            "conv_bytes": sum(c.bytes for c in sp),
            "conv_least_s": sum(max(c.flops / peak_flops,
                                    c.bytes / peak_bytes) for c in sp),
            "conv_calls": len(sp)}


def centerpoint_infer_calls(coords: torch.Tensor, grid, batch: int,
                            itemsize: int = 2) -> List[Call]:
    """Every matrix product of one CenterPoint-ELKv3 forward over a batch
    whose level-0 coords (N, 4) (x, y, z, b) are given: the sparse
    backbone (SubM 3^3 convs, strided spconvs k3 s2, the ELK blocks'
    local convs and linears, the extra z conv), the RPN and the head's
    dense convs. Products in the compute dtype (`itemsize`)."""
    from ..scenes.audit import DET_DOWNS, spconv_out
    calls = []
    shape = (grid[0], grid[1], grid[2] + 1)
    c = coords.to(torch.int64)
    chans = (16, 32, 64, 128)

    def sub(name, cc, ci, co):
        n = int(cc.shape[0])
        calls.append(Call(name, "fwd", 27, subm_pairs(cc, 3, 1), n, n, ci, co,
                          True, itemsize))

    def strided(name, cc, k, st, pad, shp, ci, co):
        out, out_shape = spconv_out(cc, k, st, pad, shp)
        lk = S.Lookup(cc)
        pairs = 0
        s = torch.tensor(st, device=cc.device)
        pd = torch.tensor(pad, device=cc.device)
        for t in itertools.product(*(range(v) for v in k)):
            q = out.clone()
            q[:, :3] = out[:, :3] * s - pd + torch.tensor(t, device=cc.device)
            pairs += int((lk(q) >= 0).sum())
        calls.append(Call(name, "fwd", int(np.prod(k)), pairs, int(cc.shape[0]),
                          int(out.shape[0]), ci, co, True, itemsize))
        return out, out_shape

    sub("conv_input", c, 5, 16)
    for lvl in range(4):
        ch = chans[lvl]
        if lvl:
            k, st, pad = DET_DOWNS[lvl - 1]
            c, shape = strided(f"down{lvl + 1}", c, k, st, pad, shape,
                               chans[lvl - 1], ch)
        n = int(c.shape[0])
        for i in range(4):
            sub(f"conv{lvl + 1}.{i}", c, ch, ch)
        sub(f"conv{lvl + 1}_tail", c, ch, ch)
        sub(f"elk{lvl + 1}.local_mix", c, ch, ch)
        sub(f"elk{lvl + 1}_tail", c, ch, ch)
        calls.append(Call(f"elk{lvl + 1}.pre_mix", "fwd", 1, n, n, n, ch, ch,
                          False, itemsize))
        calls.append(Call(f"elk{lvl + 1}.pos_weight", "fwd", 1, n, n, n, 3, ch,
                          False, itemsize))
    c, shape = strided("extra_conv", c, (1, 1, 3), (1, 1, 2), (0, 0, 0), shape,
                       128, 128)

    def dense(name, hw_out, ci, co, k):
        # pairs: output cells x taps, each reading one input cell
        m = batch * hw_out[0] * hw_out[1]
        calls.append(Call(name, "fwd", k * k, m * k * k, m, m, ci, co, False,
                          itemsize))

    h0, w0 = shape[1], shape[0]
    h1, w1 = (h0 - 1) // 2 + 1, (w0 - 1) // 2 + 1
    dense("rpn.0.0", (h0, w0), 128 * shape[2], 128, 3)
    for j in range(5):
        dense(f"rpn.0.{j + 1}", (h0, w0), 128, 128, 3)
    dense("rpn.1.0", (h1, w1), 128, 256, 3)
    for j in range(5):
        dense(f"rpn.1.{j + 1}", (h1, w1), 256, 256, 3)
    dense("rpn.up0", (h0, w0), 128, 256, 1)
    # the transposed conv: each input cell feeds 2 x 2 output cells
    calls.append(Call("rpn.up1", "fwd", 4, batch * h1 * w1 * 4,
                      batch * h1 * w1, batch * h0 * w0, 256, 256, False,
                      itemsize))
    dense("head.shared", (h0, w0), 512, 64, 3)
    for t, ncls in enumerate((1, 2, 2, 1, 2, 2)):
        for br, co in (("reg", 2), ("height", 1), ("dim", 3), ("rot", 2),
                       ("vel", 2), ("hm", ncls)):
            dense(f"head.{t}.{br}.0", (h0, w0), 64, 64, 3)
            dense(f"head.{t}.{br}.1", (h0, w0), 64, co, 3)
    return calls
