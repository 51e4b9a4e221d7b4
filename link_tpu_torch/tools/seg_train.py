"""Segmentation training entry point of the PyTorch port.

Counterpart of tools/seg_train.py (reference segmentation/train.py:31-184):
config cascade, data-parallel training with the per-iteration
cosine-warmup LR, val mIoU each epoch, rotating + best checkpoints. The
model is built with `remat=True`, as the JAX tool builds it.
Trains on the SemanticKITTI tree at `dataset.root` (train split; val split
for the mIoU), or on synthetic scans with `--synthetic`.

Data parallel with one process per replica (`link_tpu_torch.parallel`):
start one process per rank with `--coordinator host:port (or an init URL
such as file:///shared/rdv) --num-processes W --process-id R`, or under
torchrun, which sets RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT /
LOCAL_RANK. Each rank trains `batch_size` scans a step (world batch
batch_size x W), on `cuda:{local rank}` over NCCL by default, or on the
device and backend given (`--device cpu` takes gloo; several ranks on one
card need `--dist-backend gloo --device cuda:0`, as NCCL refuses them).
Rank 0 alone logs and writes checkpoints; every rank loads on --resume;
rank r validates the val scans r, r + W, ... and the IoU counters are
summed over the ranks.

Usage:
  python3 -m link_tpu_torch.tools.seg_train \
      configs/semantic_kitti/linkunet/default.yaml [--synthetic] \
      [--epochs N] [--run-dir D] [--resume [auto|path]] \
      [--stop-after-epoch N] [--device cpu] [--coordinator A \
      --num-processes W --process-id R] [--dist-backend nccl|gloo] \
      [key=value ...]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data.collate import collate_scans
from ..data.loader import PrefetchLoader, epoch_indices, shard_indices
from ..data.semantic_kitti import (SemanticKITTI, SyntheticSemanticKITTI,
                                   dataset_root)
from ..models import builder
from ..parallel import multihost as mh
from ..train import trainer as T
from ..train.checkpoint import (checkpoint_meta, find_resume, load_checkpoint,
                                save_checkpoint)
from ..train.metrics import MeanIoU
from ..utils.config import load_config
from ..utils.logging import (MetricsLogger, TensorboardLogger,
                             save_runtime_code)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="use the synthetic dataset (no real data needed)")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--resume", nargs="?", const="auto", default=None,
                    help="checkpoint path, or bare/`auto` to continue from "
                         "the run dir's latest.pt if one exists")
    ap.add_argument("--stop-after-epoch", type=int, default=None,
                    help="exit cleanly after checkpointing this epoch; the "
                         "LR schedule still spans the full num_epochs, so a "
                         "later --resume continues the same recipe")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: cuda:{local rank}), cuda:N or "
                         "cpu")
    mh.add_dist_args(ap)
    ap.add_argument("overrides", nargs="*")
    # key=value overrides may follow the options (older Pythons' argparse
    # leaves them unmatched with parse_args)
    return ap.parse_intermixed_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    if args.epochs:
        cfg.num_epochs = args.epochs
    mesh = mh.init_from_args(args)
    device, rank, world = mesh.device, mesh.rank, mesh.world_size
    is_main = rank == 0
    batch = cfg.batch_size
    world_batch = batch * world

    if args.synthetic:
        print("using synthetic dataset")
        train_ds = SyntheticSemanticKITTI(
            length=cfg.dataset.get("synthetic_length", 64),
            voxel_size=cfg.dataset.voxel_size,
            num_points=cfg.dataset.num_points, split="train")
        val_ds = SyntheticSemanticKITTI(
            length=8, voxel_size=cfg.dataset.voxel_size,
            num_points=cfg.dataset.num_points, split="train")
        cfg.data.training_size = len(train_ds)
    else:
        train_ds, val_ds = (SemanticKITTI(
            dataset_root(cfg.dataset.root), split, cfg.dataset.voxel_size,
            cfg.dataset.num_points) for split in ("train", "val"))
        if not len(train_ds) or not len(val_ds):
            raise FileNotFoundError(
                f"{cfg.dataset.root}: {len(train_ds)} train and "
                f"{len(val_ds)} val scans (sequences/<seq>/velodyne/*.bin)")
        print(f"SemanticKITTI at {cfg.dataset.root}: {len(train_ds)} train, "
              f"{len(val_ds)} val scans")

    # capacities scale with the per-replica batch, not the world
    caps = tuple(c * batch for c in cfg.model.get("capacities"))
    seed = cfg.train.seed
    # rematerialized blocks (the plans and conv outputs kept), as the JAX
    # tool always trains
    model = builder.make_model(
        cfg, capacities=caps, dtype=cfg.model.get("dtype", "float32"),
        device=device, generator=torch.Generator().manual_seed(seed),
        remat=True)
    lr = builder.make_lr_schedule(cfg, world_size=world)
    opt = builder.make_optimizer(cfg, model.parameters(), lr(0))
    state = T.TrainState(model, opt)
    train_step = T.make_dp_train_step(model, opt, mesh,
                                      ignore_label=cfg.criterion.ignore_index)
    eval_step = T.make_dp_eval_step(model, mesh, cfg.data.num_classes,
                                    cfg.data.ignore_label)
    if is_main:
        nparams = sum(p.numel() for p in model.parameters())
        print(f"params: {nparams / 1e6:.2f}M, world batch {world_batch}")

    def make_batch(ds, idxs, rng=None):
        scans = [ds[int(i)] if rng is None else ds.__getitem__(int(i), rng)
                 for i in idxs]
        return collate_scans(scans, caps[0],
                             ignore_label=cfg.data.ignore_label)

    run_dir = args.run_dir or os.path.join(
        "runs", os.path.splitext(os.path.basename(args.config))[0]
        + time.strftime("-%m%d%H%M"))

    start_epoch = 1
    if args.resume:
        rp = find_resume(run_dir) if args.resume == "auto" else args.resume
        if rp:
            # model, batch statistics, optimizer state and the step count,
            # so the LR schedule continues exactly
            load_checkpoint(rp, state)
            start_epoch = int(checkpoint_meta(rp).get("epoch", 0)) + 1
            print(f"resumed {rp} -> starting at epoch {start_epoch}, step "
                  f"{state.step}, lr {lr(state.step):.6g}")
        elif args.resume != "auto":
            raise FileNotFoundError(args.resume)

    if is_main:     # rank 0 logs and checkpoints (train.py:129-139)
        os.makedirs(run_dir, exist_ok=True)
        save_runtime_code(run_dir)
        jlog = MetricsLogger(run_dir, interval=1)
        tb = TensorboardLogger(run_dir)

    steps_per_epoch = max(1, len(train_ds) // world_batch)
    for epoch in range(start_epoch, cfg.num_epochs + 1):
        idx = epoch_indices(len(train_ds), epoch, seed)
        shard = shard_indices(idx[:steps_per_epoch * world_batch],
                              world)[rank]

        def train_batch(step, shard=shard, epoch=epoch):
            # the JAX tool's per-device generator, device = rank
            rng = np.random.default_rng(seed * 1000 + epoch * 100
                                        + step * world + rank)
            return mh.make_global_batch(mesh, [make_batch(
                train_ds, shard[step * batch:(step + 1) * batch], rng)])

        t_ep = time.time()
        losses = []
        for b in PrefetchLoader(train_batch, steps_per_epoch):
            metrics = train_step(b, lr=lr(state.step))
            state.step += 1
            losses.append(metrics["loss"])
        loss = float(torch.stack(losses).mean())    # waits for the device
        dt = time.time() - t_ep
        if is_main:
            print(f"epoch {epoch}: loss={loss:.4f} "
                  f"({steps_per_epoch * world_batch / dt:.2f} scans/s)",
                  flush=True)

        # validation (voxel-level mIoU), one scan a forward: the val split
        # is not capped at num_points, and `batch` whole scans can exceed
        # the batch's capacity (the JAX tool collates `batch` at a time);
        # rank r takes scans r, r + W, ...
        miou_metric = MeanIoU(cfg.data.num_classes, cfg.data.ignore_label)
        for i in range(0, len(val_ds), world):
            j = i + rank
            _, counters = eval_step(make_batch(val_ds, [j])
                                    if j < len(val_ds) else None)
            miou_metric.update(counters)
        miou = miou_metric.compute()
        if is_main:
            print(f"epoch {epoch}: val mIoU (voxel) = {miou * 100:.2f}",
                  flush=True)
            scalars = {"loss/train": loss, "iou/val": float(miou),
                       "scans_per_sec": steps_per_epoch * world_batch / dt}
            jlog.log({"epoch": epoch, **scalars})
            tb.scalars(scalars, epoch)
            tb.flush()
            path = save_checkpoint(run_dir, state, epoch, metric=miou,
                                   meta={"config": args.config})
            print(f"rank 0 wrote {path}", flush=True)
        if args.stop_after_epoch and epoch >= args.stop_after_epoch:
            if is_main:
                print(f"stopping after epoch {epoch} (--stop-after-epoch)",
                      flush=True)
            break
    if mesh.group is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
