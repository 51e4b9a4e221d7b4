"""Parameter conversion between the JAX ELKUNet's flax trees and the port.

The port's parameter names are the reference torch `state_dict` keys, so a
reference checkpoint (or a golden `*_state.npz`) loads into
`link_tpu_torch.models.linkunet.ELKUNet` with `load_state_dict` directly.
`from_jax_params` maps the JAX model's flax `params` / `batch_stats` trees
(numpy arrays) onto such a dict; it is the inverse of
`link_tpu/utils/torch_import.py:translate_elkunet`, Linear transposes
included.
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
