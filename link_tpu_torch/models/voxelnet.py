"""VoxelNet detector: reader -> sparse backbone -> RPN -> CenterHead.

PyTorch counterpart of `link_tpu/models/voxelnet.py` (reference
detection/det3d/models/detectors/voxelnet.py:10-96 and
readers/voxel_encoder.py:8-25), for serving and training
(`train/det_trainer.py`). Submodules are named `backbone`, `neck` and
`bbox_head` as in the reference `state_dict`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from .center_head import NUSC_TASKS, CenterHead
from .rpn import RPN
from .scn import DET_CAPACITIES, SpMiddleResNetFHDELKv3


def voxel_feature_extractor_v3(voxels: torch.Tensor,
                               num_points: torch.Tensor) -> torch.Tensor:
    """voxels (N, max_pts, F), num_points (N,) -> (N, F) mean over the
    voxel's points (VoxelFeatureExtractorV3)."""
    s = voxels.sum(dim=1)
    return s / num_points.clamp(min=1).to(voxels.dtype)[:, None]


class VoxelNet(nn.Module):
    """`dtype` is the compute dtype of backbone, neck and head (parameters
    and the box decode stay float32)."""

    def __init__(self, num_input_features: int = 5, batch_size: int = 1,
                 grid_shape: Tuple[int, int, int] = (1440, 1440, 40),
                 capacities: Tuple[int, ...] = DET_CAPACITIES,
                 tasks: Tuple[Tuple[str, ...], ...] = NUSC_TASKS,
                 dtype: str = "float32", device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.grid_shape = tuple(grid_shape)
        self.tasks = tuple(tuple(t) for t in tasks)
        self.backbone = SpMiddleResNetFHDELKv3(
            num_input_features=num_input_features, capacities=capacities,
            batch_size=batch_size, dtype=dtype, device=device,
            generator=generator)
        self.neck = RPN(dtype=dtype, device=device)
        self.bbox_head = CenterHead(tasks=self.tasks, dtype=dtype,
                                    device=device)
        if generator is not None:
            self._init_dense(generator)

    def _init_dense(self, generator: torch.Generator) -> None:
        """Seeded uniform init of the dense convs (the torch default bound
        1/sqrt(fan_in)), drawn on the CPU so a seed gives the same weights
        on every device; the hm branches keep their -2.19 final bias."""
        with torch.no_grad():
            for name, mod in self.named_modules():
                if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                    w = mod.weight
                    bound = w[0].numel() ** -0.5    # torch's fan_in
                    w.copy_(torch.empty(w.shape).uniform_(
                        -bound, bound, generator=generator))
                    if mod.bias is not None and not name.endswith("hm.3"):
                        mod.bias.copy_(torch.empty(mod.bias.shape).uniform_(
                            -bound, bound, generator=generator))

    def forward(self, voxels: torch.Tensor, coords: torch.Tensor,
                num_points: torch.Tensor,
                nnz: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        feats = voxel_feature_extractor_v3(voxels, num_points)
        bev = self.backbone(feats, coords, nnz, self.grid_shape)
        return self.bbox_head(self.neck(bev))
