"""Parameter conversion between the JAX models' flax trees and the port.

The port's parameter names are the reference torch `state_dict` keys, so a
reference checkpoint (or a golden `*_state.npz`) loads into the port's
models with `load_state_dict` directly. `from_jax_params` maps the JAX
ELKUNet's flax `params` / `batch_stats` trees (numpy arrays) onto such a
dict, the inverse of `link_tpu/utils/torch_import.py:translate_elkunet`;
`from_jax_det_params` does the same for the JAX VoxelNet, the inverse of
`link_tpu/utils/torch_import_det.py:translate_voxelnet` (spconv weight
layouts, Linear and Conv2d transposes, the ConvTranspose spatial flip).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def from_jax_params(params: Dict[str, Any],
                    batch_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ELKUNet {params, batch_stats} -> reference-keyed state_dict."""
    sd: Dict[str, torch.Tensor] = {}

    def bn(prefix, p, s):
        sd[f"{prefix}.weight"] = _t(p["scale"])
        sd[f"{prefix}.bias"] = _t(p["bias"])
        sd[f"{prefix}.running_mean"] = _t(s["mean"])
        sd[f"{prefix}.running_var"] = _t(s["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def conv_bn_block(prefix, p, s):
        sd[f"{prefix}.net.0.kernel"] = _t(p["SparseConv3d_0"]["kernel"])
        bn(f"{prefix}.net.1", p["SparseBatchNorm_0"], s["SparseBatchNorm_0"])

    def res_block(prefix, p, s):
        conv_bn_block(prefix, p, s)
        sd[f"{prefix}.net.3.kernel"] = _t(p["SparseConv3d_1"]["kernel"])
        bn(f"{prefix}.net.4", p["SparseBatchNorm_1"], s["SparseBatchNorm_1"])
        if "SparseConv3d_2" in p:
            sd[f"{prefix}.downsample.0.kernel"] = _t(
                p["SparseConv3d_2"]["kernel"])
            bn(f"{prefix}.downsample.1", p["SparseBatchNorm_2"],
               s["SparseBatchNorm_2"])

    sd["stem.0.kernel"] = _t(params["stem0"]["kernel"])
    bn("stem.1", params["stem0_bn"], batch_stats["stem0_bn"])
    sd["stem.3.kernel"] = _t(params["stem1"]["kernel"])
    bn("stem.4", params["stem1_bn"], batch_stats["stem1_bn"])

    for lvl in range(1, 5):
        conv_bn_block(f"down{lvl}.0", params[f"down{lvl}"],
                      batch_stats[f"down{lvl}"])
        for bi in range(2):
            res_block(f"stage{lvl}.{bi}", params[f"stage{lvl}_{bi}"],
                      batch_stats[f"stage{lvl}_{bi}"])
        sd[f"stage{lvl}_tail.0.kernel"] = _t(
            params[f"stage{lvl}_tail"]["kernel"])
        bn(f"stage{lvl}_tail.1", params[f"stage{lvl}_tail_bn"],
           batch_stats[f"stage{lvl}_tail_bn"])

        ep = params[f"elk{lvl}"]
        pre = f"elk{lvl}"
        sd[f"{pre}.pre_mix.0.weight"] = _t(np.asarray(ep["pre_mix"]["kernel"]).T)
        sd[f"{pre}.pre_mix.1.weight"] = _t(ep["pre_mix_norm"]["scale"])
        sd[f"{pre}.pre_mix.1.bias"] = _t(ep["pre_mix_norm"]["bias"])
        sd[f"{pre}.local_mix.0.kernel"] = _t(ep["local_mix"]["kernel"])
        sd[f"{pre}.pos_weight.0.weight"] = _t(
            np.asarray(ep["pos_weight"]["kernel"]).T)
        if "alpha" in ep:
            sd[f"{pre}.alpha"] = _t(ep["alpha"])
        for name in ("norm", "norm_local"):
            sd[f"{pre}.{name}.weight"] = _t(ep[name]["scale"])
            sd[f"{pre}.{name}.bias"] = _t(ep[name]["bias"])
        sd[f"elk{lvl}_tail.0.kernel"] = _t(params[f"elk{lvl}_tail"]["kernel"])
        bn(f"elk{lvl}_tail.1", params[f"elk{lvl}_tail_bn"],
           batch_stats[f"elk{lvl}_tail_bn"])

    for lvl in range(1, 5):
        conv_bn_block(f"up{lvl}.0", params[f"up{lvl}_deconv"],
                      batch_stats[f"up{lvl}_deconv"])
        for bi in range(2):
            res_block(f"up{lvl}.1.{bi}", params[f"up{lvl}_res{bi}"],
                      batch_stats[f"up{lvl}_res{bi}"])

    sd["classifier.0.weight"] = _t(np.asarray(params["classifier"]["kernel"]).T)
    sd["classifier.0.bias"] = _t(params["classifier"]["bias"])
    return sd


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
