"""Trace the port's seg forward, det forward or a training step and sum the
device time by `record_function` scope and by kernel.

Counterpart of tools/profile_fwd.py (which reads XLA's device lanes by the
op's source file:line); here `utils/profiling.trace` runs torch.profiler
and `trace_device_ms_by_source` reads its trace. The shapes are the JAX
tool's:
  * seg (default): ELKUNet cr1.0 in bfloat16 at DEFAULT_CAPACITIES on
    synthetic 80k-voxel scans with the 0.05 m grid extent; with --train
    one SGD step (lr 0.01) of the same model built with remat=True (the
    production step) on the same scans;
  * --det: CenterPoint-ELKv3 forward + box decode at the 160k-voxel cap
    (capacities `det_capacities(163840, 1)`) on
    synthetic nuScenes frames, in --dtype, with --dense-from L the hybrid
    dense backbone from level L;
  * --det --train: one det training step at the same cap (one-cycle Adam,
    lr_max 1e-3 over 1,000 steps).
After a first call (the kernels' build included) and two steady ones, it
prints each call's time, then traces --iters more calls into --trace-dir
and prints the --top entries by scope and by kernel, and each hand
kernel's launches per call (the wrappers' counts).

Usage:
  python3 -m link_tpu_torch.tools.profile_fwd [--det] [--train] \
      [--dense-from L] [--dtype bfloat16] [--iters 2] [--top 40] \
      [--trace-dir runs/profile_fwd] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from ..data import det_pipeline as dp
from ..data.collate import collate_scans
from ..data.nuscenes import SyntheticNuScenes
from ..data.semantic_kitti import SyntheticSemanticKITTI, grid_extent
from ..models.center_head import decode_boxes
from ..models.linkunet import DEFAULT_CAPACITIES, ELKUNet
from ..models.scn import det_capacities
from ..models.voxelnet import VoxelNet
from ..ops import kernels
from ..sparse.tensor import make_sparse_tensor
from ..train import det_trainer as DT
from ..train import schedules
from ..train import trainer as T
from ..utils import profiling

# the JAX tool's shapes
SEG_CAPS = DEFAULT_CAPACITIES
SEG_CR = 1.0
SEG_VOXELS = 80000
SEG_RAW_POINTS = 120000
SEG_VOXEL_SIZE = 0.05
DET_CAP = 163840
DET_MAX_VOXELS = 160000
DET_GRID = (1440, 1440, 40)
DET_TEST_CFG = dict(
    post_center_limit_range=[-61.2, -61.2, -10., 61.2, 61.2, 10.],
    score_threshold=0.1, pc_range=[-54, -54],
    voxel_size=[0.075, 0.075], out_size_factor=8)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--det", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--iters", type=int, default=2,
                    help="calls under the profiler")
    ap.add_argument("--trace-dir", default="runs/profile_fwd")
    ap.add_argument("--dense-from", type=int, default=None,
                    help="det hybrid dense backbone level")
    ap.add_argument("--dtype", default=None,
                    choices=("float32", "bfloat16"),
                    help="det model compute dtype (default float32)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def _det_model(args, device, batch_size=1):
    return VoxelNet(num_input_features=5, batch_size=batch_size,
                    grid_shape=DET_GRID,
                    capacities=det_capacities(DET_CAP, batch_size),
                    dense_from_level=args.dense_from,
                    dtype=args.dtype or "float32", device=device,
                    generator=torch.Generator().manual_seed(0))


def det_train_call(args, device):
    """One det training step per call, on 2 synthetic train frames in
    turn."""
    ds = SyntheticNuScenes(length=2, mode="train", seed=0,
                           max_voxels=DET_MAX_VOXELS)
    batches = [dp.collate_det([ds[i]], DET_CAP) for i in range(2)]
    model = _det_model(args, device)
    lr_fn, mom_fn = schedules.one_cycle(1e-3, 1000)
    opt = DT.make_one_cycle_adam(model, lr_fn, mom_fn)

    def call(i):
        return DT.det_train_step(model, opt, batches[i % 2])["loss"]
    return call, "step"


def det_call(args, device):
    """Forward + box decode per call, on 2 synthetic val frames in turn."""
    ds = SyntheticNuScenes(length=2, mode="val", seed=0,
                           max_voxels=DET_MAX_VOXELS)
    batches = [dp.det_inputs(dp.collate_det([ds[i]], DET_CAP), device)
               for i in range(2)]
    model = _det_model(args, device).eval()
    num_classes = [len(t) for t in model.tasks]

    def call(i):
        with torch.inference_mode():
            preds = model(*batches[i % 2])
            outs = decode_boxes(preds, DET_TEST_CFG, num_classes)
            return sum(sc.sum() for _, sc, _, _ in outs)
    return call, "frame"


def seg_inputs():
    """(grid extent, 2 collated batches of one synthetic scan each): the
    seg shapes."""
    ds = SyntheticSemanticKITTI(length=2, num_points=SEG_VOXELS,
                                n_raw_points=SEG_RAW_POINTS, split="train",
                                voxel_size=SEG_VOXEL_SIZE)
    ext = grid_extent(SEG_VOXEL_SIZE, batch_size=1)
    return ext, [collate_scans([ds[i]], SEG_CAPS[0], grid_extent=ext)
                 for i in range(2)]


def seg_model(ext, device, remat: bool = False):
    """The seg model in bfloat16 with seed-0 weights; `remat=True` is the
    production training step's (the JAX tool's remat=True model)."""
    return ELKUNet(num_classes=20, cr=SEG_CR, capacities=SEG_CAPS,
                   dtype="bfloat16", grid_extent=ext, remat=remat,
                   device=device, generator=torch.Generator().manual_seed(0))


def seg_call(args, device):
    """The seg forward (or, with --train, one SGD step of the remat model)
    per call, on 2 synthetic scans in turn."""
    ext, batches = seg_inputs()
    model = seg_model(ext, device, remat=args.train)
    if args.train:
        opt = T.make_sgd(model.parameters(), 0.01)

        def step(i):
            return T.seg_train_step(model, opt, batches[i % 2])["loss"]
        return step, "step"
    model.eval()

    def forward(i):
        b = batches[i % 2]
        with torch.inference_mode():
            st = make_sparse_tensor(b["feats"], b["coords"], nnz=b["nnz"],
                                    base_sorted=True, device=device)
            return model(st).float().sum()
    return forward, "scan"


def aggregate(stats, launches, iters: int, top: int, unit: str) -> None:
    """Print a trace's totals by scope and by kernel, and the hand kernels'
    launches, per call."""
    where = "device" if stats["device"] == "cuda" else "host (no device)"
    print(f"\n== total {where} time: {stats['total_ms'] / iters:.3f} ms "
          f"per {unit} ({iters} traced)")
    print(f"== by scope (top {top}):")
    for name, ms in sorted(stats["by_scope"].items(),
                           key=lambda kv: -kv[1])[:top]:
        print(f"  {ms / iters:9.3f} ms  {name}")
    print(f"== by kernel (top {top}):")
    for name, ms in sorted(stats["by_kernel"].items(),
                           key=lambda kv: -kv[1])[:top]:
        print(f"  {ms / iters:9.3f} ms  x{stats['launches'][name] / iters:<7g}"
              f" {name[:100]}")
    print(f"== hand kernel launches per {unit}: "
          + ", ".join(f"{k} {v / iters:g}" for k, v in launches.items()
                      if v))


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to profile on "
                           "the CPU")
    if args.det:
        call, unit = (det_train_call if args.train else det_call)(args,
                                                                  device)
    else:
        call, unit = seg_call(args, device)

    def timed(i):
        t0 = time.perf_counter()
        float(call(i))                       # waits for the device
        return time.perf_counter() - t0

    print(f"# first call (the kernels' build included): {timed(0):.1f} s",
          flush=True)
    for i in (1, 2):
        print(f"# steady: {timed(i) * 1e3:.1f} ms per {unit}", flush=True)
    kernels.reset_launch_counts()
    with profiling.trace(args.trace_dir, device):
        for i in range(args.iters):
            float(call(3 + i))
    launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    aggregate(profiling.trace_device_ms_by_source(args.trace_dir), launches,
              args.iters, args.top, unit)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
