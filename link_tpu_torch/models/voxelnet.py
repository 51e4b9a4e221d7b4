"""VoxelNet detector: reader -> sparse backbone -> RPN -> CenterHead.

PyTorch counterpart of `link_tpu/models/voxelnet.py` (reference
detection/det3d/models/detectors/voxelnet.py:10-96 and
readers/voxel_encoder.py:8-25), for serving and training
(`train/det_trainer.py`). Submodules are named `backbone`, `neck` and
`bbox_head` as in the reference `state_dict`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..utils.profiling import BEV_BWD, BEV_FWD, BackwardSpan, span
from .center_head import NUSC_TASKS, CenterHead
from .dcn import FeatureAdaption
from .rpn import RPN
from .scn import DET_CAPACITIES, SpMiddleResNetFHDELKv3


def voxel_feature_extractor_v3(voxels: torch.Tensor,
                               num_points: torch.Tensor) -> torch.Tensor:
    """voxels (N, max_pts, F), num_points (N,) -> (N, F) mean over the
    voxel's points (VoxelFeatureExtractorV3)."""
    s = voxels.sum(dim=1)
    return s / num_points.clamp(min=1).to(voxels.dtype)[:, None]


def map_head_maps(preds: List[Dict[str, torch.Tensor]], fn: Callable):
    """`fn(*maps)` over every map of the head's per-task dicts, its
    results put back in their places."""
    keys = [(t, k) for t, d in enumerate(preds) for k in d]
    maps = fn(*(preds[t][k] for t, k in keys))
    maps = maps if isinstance(maps, tuple) else (maps,)
    out = [dict(d) for d in preds]
    for (t, k), v in zip(keys, maps):
        out[t][k] = v
    return out


class VoxelNet(nn.Module):
    """`elk=False` builds the plain CenterPoint VoxelNet, whose backbone
    has no ELK branch (`scn.SpMiddleResNetFHD`). `dtype` is the compute
    dtype of backbone, neck and head (parameters and the box decode stay
    float32), in serving and in training (`train/det_trainer.py`). `dcn_head` gives the head a
    DCNSepHead per task; `dense_from_level` runs the backbone's levels from
    that one on on a masked dense grid (`models/scn.py`); `return_bev`
    makes the forward return (preds, the neck's output), the BEV map of
    the two-stage refinement (reference voxelnet.py forward_two_stage)."""

    def __init__(self, num_input_features: int = 5, batch_size: int = 1,
                 grid_shape: Tuple[int, int, int] = (1440, 1440, 40),
                 capacities: Tuple[int, ...] = DET_CAPACITIES,
                 elk: bool = True,
                 tasks: Tuple[Tuple[str, ...], ...] = NUSC_TASKS,
                 dtype: str = "float32", dcn_head: bool = False,
                 return_bev: bool = False,
                 dense_from_level: Optional[int] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.grid_shape = tuple(grid_shape)
        self.tasks = tuple(tuple(t) for t in tasks)
        self.return_bev = return_bev
        self.backbone = SpMiddleResNetFHDELKv3(
            num_input_features=num_input_features, elk=elk,
            capacities=capacities,
            batch_size=batch_size, dtype=dtype,
            dense_from_level=dense_from_level, device=device,
            generator=generator)
        self.neck = RPN(dtype=dtype, device=device)
        self.bbox_head = CenterHead(tasks=self.tasks, dcn_head=dcn_head,
                                    dtype=dtype, device=device)
        if generator is not None:
            self._init_dense(generator)

    def _init_dense(self, generator: torch.Generator) -> None:
        """Seeded uniform init of the dense convs (the torch default bound
        1/sqrt(fan_in)), drawn on the CPU so a seed gives the same weights
        on every device; the hm branches keep their -2.19 final bias, and a
        DCN head's adaptions their own init (`FeatureAdaption`)."""
        with torch.no_grad():
            for name, mod in self.named_modules():
                if isinstance(mod, FeatureAdaption):
                    mod.reset_parameters(generator)
                elif (isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d))
                      and not name.endswith("conv_offset")):
                    w = mod.weight
                    bound = w[0].numel() ** -0.5    # torch's fan_in
                    w.copy_(torch.empty(w.shape).uniform_(
                        -bound, bound, generator=generator))
                    if mod.bias is not None and not name.endswith(
                            ("hm.3", "cls_head.3")):
                        mod.bias.copy_(torch.empty(mod.bias.shape).uniform_(
                            -bound, bound, generator=generator))

    def forward(self, voxels: torch.Tensor, coords: torch.Tensor,
                num_points: torch.Tensor,
                nnz: torch.Tensor):
        """Per-task dicts of NHWC maps; with `return_bev` also the neck's
        (B, C, H, W) output."""
        feats = voxel_feature_extractor_v3(voxels, num_points)
        bev = self.backbone(feats, coords, nnz, self.grid_shape)
        with span(BEV_FWD):
            bwd = BackwardSpan(BEV_BWD, bev)
            x = self.neck(bwd.x)
            preds = self.bbox_head(x)
            if bwd.on:
                preds = map_head_maps(preds, bwd.out)
        return (preds, x) if self.return_bev else preds

    def rows_dropped(self):
        """The backbone's rows dropped at a capacity, by level."""
        return self.backbone.rows_dropped()


def report_rows_dropped(model: VoxelNet) -> tuple:
    """Prints the rows the backbone's capacities dropped, by level, with a
    warning when any was; returns them."""
    dropped = model.rows_dropped()
    if any(dropped):
        print(f"WARNING: rows dropped at the level capacities "
              f"{model.backbone.capacities}: {list(dropped)} by level",
              flush=True)
    else:
        print(f"rows dropped by level: {list(dropped)}", flush=True)
    return dropped
