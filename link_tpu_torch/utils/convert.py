"""Parameter conversion between the JAX models' flax trees and the port.

The port's parameter names are the reference torch `state_dict` keys, so a
reference checkpoint (or a golden `*_state.npz`) loads into the port's
models with `load_state_dict` directly (`load_reference_state_dict` drops
the keys of modules the reference defines and never calls).
`from_jax_params` maps the JAX ELKUNet's flax `params` / `batch_stats`
trees (numpy arrays) onto such a dict, the inverse of
`link_tpu/utils/torch_import.py:translate_elkunet`; `from_jax_elkencoder`,
`from_jax_minkunet` and `from_jax_spvcnn` do the same for the other seg
families, the inverses of `translate_elkencoder`, `translate_minkunet` and
`translate_spvcnn`; `from_jax_det_params` maps the JAX VoxelNet's, the
inverse of
`link_tpu/utils/torch_import_det.py:translate_voxelnet` (spconv weight
layouts, Linear and Conv2d transposes, the ConvTranspose spatial flip).
`to_jax_flat` goes the other way for the ELKUNet: a port `state_dict`, or
the gradients by parameter name, onto the flat names of the JAX trees, so
gradients and updated parameters can be compared leaf by leaf.
`grads_state_dict` gives any model's gradients in its reference-keyed
`state_dict` layout, which the JAX package's `translate_*` functions map
onto its trees.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


class _StateDictBuilder:
    """Builds a reference-keyed state_dict from flax {params, batch_stats}
    subtrees: one method per module kind of the seg models."""

    def __init__(self):
        self.sd: Dict[str, torch.Tensor] = {}

    def bn(self, prefix, p, s):
        sd = self.sd
        sd[f"{prefix}.weight"] = _t(p["scale"])
        sd[f"{prefix}.bias"] = _t(p["bias"])
        sd[f"{prefix}.running_mean"] = _t(s["mean"])
        sd[f"{prefix}.running_var"] = _t(s["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def linear(self, prefix, p):
        self.sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
        if "bias" in p:
            self.sd[f"{prefix}.bias"] = _t(p["bias"])

    def conv_bn_block(self, prefix, p, s):
        self.sd[f"{prefix}.net.0.kernel"] = _t(p["SparseConv3d_0"]["kernel"])
        self.bn(f"{prefix}.net.1", p["SparseBatchNorm_0"],
                s["SparseBatchNorm_0"])

    def res_block(self, prefix, p, s):
        self.conv_bn_block(prefix, p, s)
        self.sd[f"{prefix}.net.3.kernel"] = _t(p["SparseConv3d_1"]["kernel"])
        self.bn(f"{prefix}.net.4", p["SparseBatchNorm_1"],
                s["SparseBatchNorm_1"])
        if "SparseConv3d_2" in p:
            self.sd[f"{prefix}.downsample.0.kernel"] = _t(
                p["SparseConv3d_2"]["kernel"])
            self.bn(f"{prefix}.downsample.1", p["SparseBatchNorm_2"],
                    s["SparseBatchNorm_2"])

    def stem(self, params, stats):
        self.sd["stem.0.kernel"] = _t(params["stem0"]["kernel"])
        self.bn("stem.1", params["stem0_bn"], stats["stem0_bn"])
        self.sd["stem.3.kernel"] = _t(params["stem1"]["kernel"])
        self.bn("stem.4", params["stem1_bn"], stats["stem1_bn"])

    def elk_encoder(self, params, stats):
        """The stem and the 4 ELK levels of ELKUNet / ELKEncoder."""
        sd = self.sd
        self.stem(params, stats)
        for lvl in range(1, 5):
            self.conv_bn_block(f"down{lvl}.0", params[f"down{lvl}"],
                               stats[f"down{lvl}"])
            for bi in range(2):
                self.res_block(f"stage{lvl}.{bi}", params[f"stage{lvl}_{bi}"],
                               stats[f"stage{lvl}_{bi}"])
            sd[f"stage{lvl}_tail.0.kernel"] = _t(
                params[f"stage{lvl}_tail"]["kernel"])
            self.bn(f"stage{lvl}_tail.1", params[f"stage{lvl}_tail_bn"],
                    stats[f"stage{lvl}_tail_bn"])

            ep = params[f"elk{lvl}"]
            pre = f"elk{lvl}"
            self.linear(f"{pre}.pre_mix.0", ep["pre_mix"])
            sd[f"{pre}.pre_mix.1.weight"] = _t(ep["pre_mix_norm"]["scale"])
            sd[f"{pre}.pre_mix.1.bias"] = _t(ep["pre_mix_norm"]["bias"])
            sd[f"{pre}.local_mix.0.kernel"] = _t(ep["local_mix"]["kernel"])
            self.linear(f"{pre}.pos_weight.0", ep["pos_weight"])
            if "alpha" in ep:
                sd[f"{pre}.alpha"] = _t(ep["alpha"])
            for name in ("norm", "norm_local"):
                sd[f"{pre}.{name}.weight"] = _t(ep[name]["scale"])
                sd[f"{pre}.{name}.bias"] = _t(ep[name]["bias"])
            sd[f"elk{lvl}_tail.0.kernel"] = _t(
                params[f"elk{lvl}_tail"]["kernel"])
            self.bn(f"elk{lvl}_tail.1", params[f"elk{lvl}_tail_bn"],
                    stats[f"elk{lvl}_tail_bn"])

    def decoder(self, params, stats):
        for lvl in range(1, 5):
            self.conv_bn_block(f"up{lvl}.0", params[f"up{lvl}_deconv"],
                               stats[f"up{lvl}_deconv"])
            for bi in range(2):
                self.res_block(f"up{lvl}.1.{bi}", params[f"up{lvl}_res{bi}"],
                               stats[f"up{lvl}_res{bi}"])

    def unet_body(self, params, stats):
        """MinkUNet / SPVCNN: stage{l} = (down, res, res), then the
        decoder (link_tpu/utils/torch_import.py:_unet_body_sd)."""
        self.stem(params, stats)
        for lvl in range(1, 5):
            self.conv_bn_block(f"stage{lvl}.0", params[f"down{lvl}"],
                               stats[f"down{lvl}"])
            for bi in range(2):
                self.res_block(f"stage{lvl}.{bi + 1}",
                               params[f"stage{lvl}_{bi}"],
                               stats[f"stage{lvl}_{bi}"])
        self.decoder(params, stats)


def from_jax_params(params: Dict[str, Any],
                    batch_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ELKUNet {params, batch_stats} -> reference-keyed state_dict."""
    b = _StateDictBuilder()
    b.elk_encoder(params, batch_stats)
    b.decoder(params, batch_stats)
    b.linear("classifier.0", params["classifier"])
    return b.sd


def from_jax_elkencoder(params: Dict[str, Any], batch_stats: Dict[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """flax ELKEncoder -> the port's state_dict (the reference's keys
    without its unused decoder): the inverse of
    `link_tpu/utils/torch_import.py:translate_elkencoder`. The grouped
    heads' (g, Ci/g, Co/g) kernels become Conv1d (Co, Ci/g, 1) weights."""
    b = _StateDictBuilder()
    b.elk_encoder(params, batch_stats)
    for head, key in (("head0", "classifier.0"), ("head1", "classifier.2")):
        kern = np.asarray(params[head]["kernel"])            # (g, ci, co/g)
        g, ci, cog = kern.shape
        b.sd[f"{key}.weight"] = _t(
            kern.transpose(0, 2, 1).reshape(g * cog, ci)[:, :, None])
        b.sd[f"{key}.bias"] = _t(np.asarray(params[head]["bias"]).reshape(-1))
    return b.sd


def from_jax_minkunet(params: Dict[str, Any], batch_stats: Dict[str, Any]
                      ) -> Dict[str, torch.Tensor]:
    """flax MinkUNet -> the port's state_dict: the inverse of
    `translate_minkunet`."""
    b = _StateDictBuilder()
    b.unet_body(params, batch_stats)
    b.linear("classifier.0", params["classifier"])
    return b.sd


def from_jax_spvcnn(params: Dict[str, Any], batch_stats: Dict[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """flax SPVCNN -> the port's state_dict: the inverse of
    `translate_spvcnn` (the U-Net body, the three point MLPs)."""
    b = _StateDictBuilder()
    b.unet_body(params, batch_stats)
    for i in range(3):
        p, s = params[f"pt{i}"], batch_stats[f"pt{i}"]
        b.linear(f"point_transforms.{i}.0", p["Linear_0"])
        b.bn(f"point_transforms.{i}.1", p["SparseBatchNorm_0"],
             s["SparseBatchNorm_0"])
    b.linear("classifier.0", params["classifier"])
    return b.sd


def grads_state_dict(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The model's `state_dict` as numpy arrays with every parameter
    replaced by its gradient (zeros where it has none) and the buffers as
    they are: the reference layout the `translate_*` functions read."""
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
             for k, p in model.named_parameters()}
    return {k: grads.get(k, v).detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def load_reference_state_dict(model: torch.nn.Module,
                              sd: Dict[str, torch.Tensor]) -> None:
    """Load a reference state_dict into a port model with `strict=True`,
    after dropping the keys of the modules the reference defines but its
    forward never calls, which the port leaves out: the prefixes the model
    class names in `UNUSED_REFERENCE_KEYS` (ELKEncoder's decoder, MinkUNet's
    point transforms). Every other key must match."""
    unused = tuple(getattr(model, "UNUSED_REFERENCE_KEYS", ()))
    model.load_state_dict({k: v for k, v in sd.items()
                           if not (unused and k.startswith(unused))},
                          strict=True)


_BN_LEAF = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("batch_stats", "mean"),
            "running_var": ("batch_stats", "var")}
_BLOCK_SLOT = {"net.0": "SparseConv3d_0", "net.1": "SparseBatchNorm_0",
               "net.3": "SparseConv3d_1", "net.4": "SparseBatchNorm_1",
               "downsample.0": "SparseConv3d_2",
               "downsample.1": "SparseBatchNorm_2"}
_ELK_SLOT = {"pre_mix.0": "pre_mix", "pre_mix.1": "pre_mix_norm",
             "local_mix.0": "local_mix", "pos_weight.0": "pos_weight",
             "norm": "norm", "norm_local": "norm_local"}


def _jax_name(key: str):
    """Port ELKUNet key -> (collection, flax path, transposed), or None for
    a key the JAX trees do not hold (num_batches_tracked)."""
    mod, _, leaf = key.rpartition(".")
    if leaf == "num_batches_tracked":
        return None
    if mod == "classifier.0":
        return "params", f"classifier/{'kernel' if leaf == 'weight' else leaf}", \
            leaf == "weight"
    m = re.fullmatch(r"(elk\d)\.(.+)", mod)
    if m:                                           # ELK block internals
        slot = _ELK_SLOT[m.group(2)]
        if leaf == "kernel":
            return "params", f"{m.group(1)}/{slot}/kernel", False
        if slot in ("pre_mix", "pos_weight"):       # Linear: (out, in)
            return "params", f"{m.group(1)}/{slot}/kernel", True
        return "params", f"{m.group(1)}/{slot}/" \
            f"{'scale' if leaf == 'weight' else leaf}", False
    if re.fullmatch(r"elk\d", mod):
        return "params", f"{mod}/{leaf}", False      # alpha
    # module path of a conv or a norm -> flax scope
    m = re.fullmatch(r"stem\.(\d)", mod)
    if m:
        scope = {"0": "stem0", "1": "stem0_bn", "3": "stem1",
                 "4": "stem1_bn"}[m.group(1)]
    elif re.fullmatch(r"(stage|elk)\d_tail\.[01]", mod):
        base, i = mod.rsplit(".", 1)
        scope = base if i == "0" else base + "_bn"
    else:
        m = (re.fullmatch(r"(down\d)\.0\.(net\.\d)", mod)
             or re.fullmatch(r"(stage\d)\.(\d)\.((?:net|downsample)\.\d)", mod)
             or re.fullmatch(r"(up\d)\.0\.(net\.\d)", mod)
             or re.fullmatch(r"(up\d)\.1\.(\d)\.((?:net|downsample)\.\d)", mod))
        if m is None:
            raise KeyError(f"no JAX name for {key!r}")
        g = m.groups()
        if len(g) == 2:
            block = g[0] + ("_deconv" if g[0].startswith("up") else "")
        else:
            block = (f"{g[0]}_res{g[1]}" if g[0].startswith("up")
                     else f"{g[0]}_{g[1]}")
        scope = f"{block}/{_BLOCK_SLOT[g[-1]]}"
    if leaf == "kernel":
        return "params", f"{scope}/kernel", False
    coll, name = _BN_LEAF[leaf]
    return coll, f"{scope}/{name}", False


def to_jax_flat(named: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Port ELKUNet tensors by `state_dict` key (parameters, buffers or
    gradients) -> {"params/<flax path>" or "batch_stats/<flax path>": numpy
    array}, in the JAX layouts: the inverse of `from_jax_params`."""
    out: Dict[str, np.ndarray] = {}
    for key, value in named.items():
        name = _jax_name(key)
        if name is None:
            continue
        coll, path, transposed = name
        a = value.detach().cpu().numpy()
        out[f"{coll}/{path}"] = a.T if transposed else a
    return out


def _subm_weight(kernel) -> torch.Tensor:
    """(27, Ci, Co) submanifold taps (z-major, x fastest) -> spconv
    (Co, kz, ky, kx, Ci)."""
    k = np.asarray(kernel)
    return _t(k.reshape(3, 3, 3, k.shape[1], k.shape[2]).transpose(
        4, 0, 1, 2, 3))


def _engine_weight(kernel, ks) -> torch.Tensor:
    """(K, Ci, Co) strided-engine taps (x-major, z fastest) for kernel size
    ks = (kx, ky, kz) -> spconv (Co, kz, ky, kx, Ci)."""
    k = np.asarray(kernel)
    return _t(k.reshape(ks[0], ks[1], ks[2], k.shape[1], k.shape[2])
              .transpose(4, 2, 1, 0, 3))


def _conv2d(kernel) -> torch.Tensor:
    """flax Conv (kh, kw, Ci, Co) -> torch Conv2d (Co, Ci, kh, kw)."""
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _deconv2d(kernel) -> torch.Tensor:
    """flax ConvTranspose (kh, kw, Ci, Co) -> torch ConvTranspose2d
    (Ci, Co, kh, kw), spatially flipped."""
    return _t(np.asarray(kernel).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])


def from_jax_det_params(params: Dict[str, Any],
                        batch_stats: Dict[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """flax VoxelNet {params, batch_stats} (backbone, neck, bbox_head) ->
    reference-keyed det3d state_dict."""
    sd: Dict[str, torch.Tensor] = {}

    def bn(prefix, p, s):
        sd[f"{prefix}.weight"] = _t(p["scale"])
        sd[f"{prefix}.bias"] = _t(p["bias"])
        sd[f"{prefix}.running_mean"] = _t(s["mean"])
        sd[f"{prefix}.running_var"] = _t(s["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    P, S = params["backbone"], batch_stats["backbone"]
    B = "backbone"
    sd[f"{B}.conv_input.0.weight"] = _subm_weight(P["conv_input"]["kernel"])
    bn(f"{B}.conv_input.1", P["conv_input_bn"], S["conv_input_bn"])
    for lvl in range(1, 5):
        if lvl > 1:
            sd[f"{B}.down{lvl}.0.weight"] = _engine_weight(
                P[f"down{lvl}"]["kernel"], (3, 3, 3))
            bn(f"{B}.down{lvl}.1", P[f"down{lvl}"]["SparseBatchNorm_0"],
               S[f"down{lvl}"]["SparseBatchNorm_0"])
        for bi in range(2):
            p, s = P[f"conv{lvl}_{bi}"], S[f"conv{lvl}_{bi}"]
            pre = f"{B}.conv{lvl}.{bi}"
            for ci in range(2):
                conv = p[f"SparseConv3d_{ci}"]
                sd[f"{pre}.conv{ci + 1}.weight"] = _subm_weight(conv["kernel"])
                sd[f"{pre}.conv{ci + 1}.bias"] = _t(conv["bias"])
                bn(f"{pre}.bn{ci + 1}", p[f"SparseBatchNorm_{ci}"],
                   s[f"SparseBatchNorm_{ci}"])
        for tail in (f"conv{lvl}_tail", f"elk{lvl}_tail"):
            sd[f"{B}.{tail}.0.weight"] = _subm_weight(P[tail]["kernel"])
            bn(f"{B}.{tail}.1", P[f"{tail}_bn"], S[f"{tail}_bn"])
        ep = P[f"elk{lvl}"]
        pre = f"{B}.elk{lvl}"
        sd[f"{pre}.pre_mix.0.weight"] = _t(np.asarray(ep["pre_mix"]["kernel"]).T)
        sd[f"{pre}.pre_mix.1.weight"] = _t(ep["pre_mix_norm"]["scale"])
        sd[f"{pre}.pre_mix.1.bias"] = _t(ep["pre_mix_norm"]["bias"])
        sd[f"{pre}.local_mix.0.kernel"] = _t(ep["local_mix"]["kernel"])
        sd[f"{pre}.pos_weight.0.weight"] = _t(
            np.asarray(ep["pos_weight"]["kernel"]).T)
        for name in ("norm", "norm_local"):
            sd[f"{pre}.{name}.weight"] = _t(ep[name]["scale"])
            sd[f"{pre}.{name}.bias"] = _t(ep[name]["bias"])
    sd[f"{B}.extra_conv.0.weight"] = _engine_weight(P["extra_conv_kernel"],
                                                    (1, 1, 3))
    bn(f"{B}.extra_conv.1", P["extra_conv_bn"], S["extra_conv_bn"])

    P, S = params["neck"], batch_stats["neck"]
    blk = 0
    while f"block{blk}_conv0" in P:
        ci = 0
        while f"block{blk}_conv{ci}" in P:
            name = f"block{blk}_conv{ci}"
            tid = 1 + 3 * ci
            sd[f"neck.blocks.{blk}.{tid}.weight"] = _conv2d(
                P[name]["Conv_0"]["kernel"])
            bn(f"neck.blocks.{blk}.{tid + 1}", P[name]["BatchNorm_0"],
               S[name]["BatchNorm_0"])
            ci += 1
        blk += 1
    for i in range(blk):
        name = f"deblock{i}"
        if name not in P:
            continue
        if "ConvTranspose_0" in P[name]:
            w = _deconv2d(P[name]["ConvTranspose_0"]["kernel"])
        else:
            w = _conv2d(P[name]["Conv_0"]["kernel"])
        sd[f"neck.deblocks.{i}.0.weight"] = w
        bn(f"neck.deblocks.{i}.1", P[name]["BatchNorm_0"],
           S[name]["BatchNorm_0"])

    P, S = params["bbox_head"], batch_stats["bbox_head"]
    H = "bbox_head"
    sd[f"{H}.shared_conv.0.weight"] = _conv2d(P["shared_conv"]["kernel"])
    sd[f"{H}.shared_conv.0.bias"] = _t(P["shared_conv"]["bias"])
    bn(f"{H}.shared_conv.1", P["shared_bn"], S["shared_bn"])
    t = 0
    while f"task{t}_hm" in P:
        for head in ("reg", "height", "dim", "rot", "vel", "hm"):
            name = f"task{t}_{head}"
            pre = f"{H}.tasks.{t}.{head}"
            sd[f"{pre}.0.weight"] = _conv2d(P[name]["conv0"]["kernel"])
            sd[f"{pre}.0.bias"] = _t(P[name]["conv0"]["bias"])
            bn(f"{pre}.1", P[name]["bn0"], S[name]["bn0"])
            sd[f"{pre}.3.weight"] = _conv2d(P[name]["final"]["kernel"])
            sd[f"{pre}.3.bias"] = _t(P[name]["final"]["bias"])
        t += 1
    return sd
