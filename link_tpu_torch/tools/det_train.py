"""Detection training entry point of the PyTorch port.

Counterpart of tools/det_train.py (reference detection/tools/train.py) on
one process and one device: CenterPoint-ELKv3 (VoxelNet) trained with
one-cycle Adam (lr_max 1e-3, momentum 0.95 -> 0.85, decoupled decay 0.01),
a global-norm clip of 35 and the CenterHead loss, the recipe read from the
reference-style config; one checkpoint per epoch, and `--resume`
continues the same one-cycle schedule.

The frames come from the train infos of a nuScenes tree
(`NuScenesDataset(mode="train")`: 10 sweeps, CBGS, global augmentation)
on the grid of `--grid`, with GT-AUG from the database of
`--db-info-path` (tools/create_data gt_database) until epoch
`--no-aug-from` (the reference's GT-AUG "fading": from that epoch on, and
also in a run resumed past it, no samples are pasted); or, with
`--synthetic`, synthetic frames on the 1440 x 1440 x 40 grid (`GRID`).

Usage:
  python3 -m link_tpu_torch.tools.det_train [--synthetic] \
      [--info-path P] [--root-path D] [--db-info-path DB] \
      [--no-aug-from 16] [--grid 1440 1440 40] \
      [--config configs/nusc/voxelnet/...elkv3.py] [--epochs N] \
      [--samples-per-device 2] [--voxel-capacity 163840] [--run-dir D] \
      [--resume [auto|path]] [--stop-after-epoch N] [--device cpu]

As in the JAX tool, --config sets the recipe, its total_epochs included
(over --epochs), and its `data.train_anno` (over --info-path). Unlike the
JAX tool, a missing info pkl or GT database raises FileNotFoundError
naming the path (JAX falls back to synthetic frames, or trains without
GT-AUG).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..data import det_pipeline as dp
from ..data.loader import PrefetchLoader, epoch_indices, shard_indices
from ..data.gt_aug import DataBaseSampler
from ..data.nuscenes import NuScenesDataset, SyntheticNuScenes
from ..models.voxelnet import VoxelNet
from ..train import det_trainer as DT
from ..train import schedules
from ..train.checkpoint import (checkpoint_meta, find_resume, load_checkpoint,
                                save_checkpoint)
from ..train.trainer import TrainState
from ..utils.config import load_config
from ..utils.logging import MetricsLogger, save_runtime_code

# the published recipe (configs/nusc/voxelnet/...elkv3.py), used without
# --config as the JAX tool uses it
RECIPE = dict(lr_max=1e-3, moms=(0.95, 0.85), div_factor=10.0,
              pct_start=0.4, wd=0.01, clip=35.0, epochs=20)
GRID = (1440, 1440, 40)     # the synthetic frames' grid (0.075 m voxels)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=None,
                    help="reference-style py config (configs/nusc/...); "
                         "sets the recipe's hyperparameters")
    ap.add_argument("--info-path", default="data/nuScenes/infos_train_"
                                           "10sweeps_withvelo_filter_True.pkl")
    ap.add_argument("--root-path", default="data/nuScenes")
    ap.add_argument("--db-info-path", default=None,
                    help="GT-AUG database (tools/create_data gt_database)")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on synthetic nuScenes frames")
    ap.add_argument("--no-aug-from", type=int, default=16,
                    help="epoch from which GT-AUG is off (fading)")
    ap.add_argument("--epochs", type=int, default=20,
                    help="without --config; a config's total_epochs wins")
    ap.add_argument("--samples-per-device", type=int, default=2)
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--voxel-capacity", type=int, default=163840)
    ap.add_argument("--grid", type=int, nargs=3, default=list(GRID),
                    help="the voxel grid of the real data (x y z)")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--dense-from-level", type=int, default=None)
    ap.add_argument("--resume", nargs="?", const="auto", default=None,
                    help="checkpoint path, or bare/`auto` to continue from "
                         "the run dir's latest.pt if one exists")
    ap.add_argument("--stop-after-epoch", type=int, default=None,
                    help="exit cleanly after checkpointing this epoch; the "
                         "one-cycle schedule still spans the full --epochs, "
                         "so a later --resume continues the same recipe")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def _unported(args) -> None:
    """Raise on the parts that wait for other slices of the port."""
    if args.dense_from_level is not None:
        raise NotImplementedError(
            "--dense-from-level: the hybrid dense backbone is not ported yet "
            "(ROADMAP §1 item 6)")
    if (args.coordinator or args.num_processes is not None
            or args.process_id is not None):
        raise NotImplementedError(
            "multi-host training: data parallelism is not ported yet "
            "(ROADMAP §1 item 8)")


def recipe(args) -> dict:
    """The one-cycle recipe: `RECIPE`, or the config's (as the JAX tool
    reads it: its total_epochs replaces --epochs, and its data.train_anno
    --info-path)."""
    rc = dict(RECIPE, epochs=args.epochs)
    if args.config:
        cfg = load_config(args.config)
        if cfg.model.bbox_head.get("dcn_head", False):
            raise NotImplementedError(
                "dcn_head: the DCN head is not ported yet (ROADMAP §1 "
                "item 6)")
        rc.update(lr_max=cfg.lr_config.lr_max, moms=tuple(cfg.lr_config.moms),
                  div_factor=cfg.lr_config.div_factor,
                  pct_start=cfg.lr_config.pct_start, wd=cfg.optimizer.wd,
                  clip=cfg.optimizer_config.grad_clip.max_norm,
                  epochs=cfg.total_epochs)
        args.info_path = cfg.data.train_anno
    return rc


def train_dataset(args):
    """The training frames and their grid: the train infos with GT-AUG, or
    synthetic frames."""
    if args.synthetic:
        print("using synthetic nuScenes")
        return (SyntheticNuScenes(length=max(8, args.samples_per_device),
                                  mode="train",
                                  max_voxels=args.voxel_capacity), GRID)
    for flag, path in (("--info-path", args.info_path),
                       ("--db-info-path", args.db_info_path)):
        if path is not None and not os.path.exists(path):
            raise FileNotFoundError(
                f"{flag}: no file at {path!r}; make it with python3 -m "
                "link_tpu_torch.tools.create_data, or pass --synthetic")
    db_sampler = (DataBaseSampler(args.db_info_path, args.root_path)
                  if args.db_info_path else None)
    return (NuScenesDataset(args.info_path, args.root_path, mode="train",
                            db_sampler=db_sampler), tuple(args.grid))


def main(argv=None) -> int:
    args = parse_args(argv)
    _unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to train on "
                           "the CPU")

    rc = recipe(args)
    epochs = rc["epochs"]
    spd = args.samples_per_device

    train_ds, grid = train_dataset(args)

    cap = args.voxel_capacity * spd
    model = VoxelNet(num_input_features=5, batch_size=spd, grid_shape=grid,
                     capacities=tuple(max(1024, cap // f)
                                      for f in (1, 2, 4, 8)),
                     device=device,
                     generator=torch.Generator().manual_seed(0))
    steps_per_epoch = max(1, len(train_ds) // spd)
    total_steps = epochs * steps_per_epoch
    lr_fn, mom_fn = schedules.one_cycle(
        rc["lr_max"], total_steps, moms=rc["moms"],
        div_factor=rc["div_factor"], pct_start=rc["pct_start"])
    opt = DT.make_one_cycle_adam(model, lr_fn, mom_fn,
                                 weight_decay=rc["wd"], grad_clip=rc["clip"])
    state = TrainState(model, opt)
    nparams = sum(p.numel() for p in model.parameters())
    print(f"params: {nparams / 1e6:.2f}M, grid {grid}, capacities "
          f"{model.backbone.capacities}, total_steps={total_steps}")

    run_dir = args.run_dir or os.path.join("runs", "det-" +
                                           time.strftime("%m%d%H%M"))
    start_epoch = 1
    if args.resume:
        rp = find_resume(run_dir) if args.resume == "auto" else args.resume
        if rp:
            # parameters, batch statistics, Adam's moments and the step
            # count, so the one-cycle schedule continues where it was
            load_checkpoint(rp, state)
            start_epoch = int(checkpoint_meta(rp).get("epoch", 0)) + 1
            print(f"resumed {rp} -> starting at epoch {start_epoch}, step "
                  f"{opt.count}, lr {lr_fn(opt.count):.6g}")
        elif args.resume != "auto":
            raise FileNotFoundError(args.resume)

    os.makedirs(run_dir, exist_ok=True)
    save_runtime_code(run_dir)
    jlog = MetricsLogger(run_dir, interval=1)

    def make_batch(idxs):
        return dp.collate_det([train_ds[int(i)] for i in idxs], cap)

    for epoch in range(start_epoch, epochs + 1):
        # >= (not ==), so that a run resumed past the fading epoch stays
        # faded
        if epoch >= args.no_aug_from and hasattr(train_ds, "db_sampler"):
            train_ds.db_sampler = None
        idx = epoch_indices(len(train_ds), epoch)
        shard = shard_indices(idx[:steps_per_epoch * spd], 1)[0]
        t0 = time.time()
        losses = []
        for b in PrefetchLoader(
                lambda step, shard=shard: make_batch(
                    shard[step * spd:(step + 1) * spd]), steps_per_epoch):
            metrics = DT.det_train_step(model, opt, b)
            state.step = opt.count
            losses.append(metrics["loss"])
        loss = float(torch.stack(losses).mean())      # waits for the device
        dt = time.time() - t0
        rate = steps_per_epoch * spd / dt
        rec = {"epoch": epoch, "step": opt.count, "loss/train": loss,
               "samples_per_sec": rate,
               "gt_aug": getattr(train_ds, "db_sampler", None) is not None}
        if device.type == "cuda":
            # since the process started: the step's peak in a fresh process
            rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"epoch {epoch}: loss={loss:.4f} ({rate:.2f} samples/s, "
              f"{dt * 1e3 / steps_per_epoch:.1f} ms/step, step {opt.count}, "
              f"lr {lr_fn(opt.count):.6g}"
              + (f", peak memory {rec['peak_mem_gb']:.2f} GB"
                 if "peak_mem_gb" in rec else "") + ")", flush=True)
        jlog.log(rec)
        save_checkpoint(run_dir, state, epoch,
                        meta={"config": args.config})
        if args.stop_after_epoch and epoch >= args.stop_after_epoch:
            print(f"stopping after epoch {epoch} (--stop-after-epoch)",
                  flush=True)
            break
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
