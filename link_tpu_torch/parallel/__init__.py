"""Data parallelism: one process per replica over `torch.distributed`.

PyTorch counterpart of `link_tpu/parallel/__init__.py`. JAX runs every
replica in one program over a 1-D `data` mesh and lets XLA insert the
gradient all-reduce; here each replica is a process with its own device
(`cuda:{local rank}`, or the CPU), NCCL joins the cards and gloo the CPU
(`parallel.multihost.maybe_initialize`), and the train steps reduce
explicitly: one flat all-reduce per step of every gradient, every
BatchNorm running statistic and the loss terms, divided by the world size
(JAX's `pmean`). A parameter without a gradient on a rank takes a zero one,
as in optax's trees. `DistributedDataParallel` is not used: it copies rank
0's running statistics (`broadcast_buffers`) where JAX averages them.

`sequential_dp_step` computes the same step in one process, running each
replica's batch in turn (`make_dp_train_step`'s vmap over replicas); it is
the reference the multi-process step is held against.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.profiler import record_function

# profiler range of the train steps' all-reduce
ALL_REDUCE_RANGE = "dp/all_reduce"


@dataclass(frozen=True)
class DataMesh:
    """This process's place in the data-parallel world: its rank, the
    world size, its device, and the process group the replicas reduce over
    (None on one process: the steps then make no collective call)."""

    rank: int
    world_size: int
    device: torch.device
    group: Optional[Any] = None


def make_data_mesh(device="cuda") -> DataMesh:
    """Stands for `make_data_mesh`: the 1-D data-parallel mesh, here the
    world of the default process group (`multihost.maybe_initialize`), or
    a world of one. `device` as `multihost.rank_device` reads it."""
    from .multihost import process_info, rank_device
    rank, world = process_info()
    group = dist.group.WORLD if world > 1 else None
    return DataMesh(rank, world, rank_device(device), group)


def _coalesced(tensors: Sequence[torch.Tensor], collective) -> None:
    """Apply `collective` (in place on a flat tensor) to `tensors` through
    one flat buffer per dtype, and copy the result back."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))


def replicated(mesh: DataMesh, module: nn.Module) -> nn.Module:
    """Stands for `replicated` (state replicated over the mesh): broadcast
    `module`'s parameters and buffers from rank 0, in place, so that every
    replica starts from the same state. Returns `module`."""
    if mesh.group is not None:
        with torch.no_grad():
            _coalesced(list(module.parameters()) + list(module.buffers()),
                       lambda flat: dist.broadcast(flat, 0, group=mesh.group))
    return module


def data_sharded(mesh: DataMesh, batches: Sequence[Any]) -> Any:
    """Stands for `data_sharded` (the leading per-replica axis split over
    the mesh): this rank's batch of a global list of per-replica
    batches."""
    if len(batches) != mesh.world_size:
        raise ValueError(f"{len(batches)} per-replica batches for a world "
                         f"of {mesh.world_size}")
    return batches[mesh.rank]


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_device_batches(batches) -> Any:
    """Stack per-replica host batches along a new leading axis, leaf by
    leaf through dicts, lists and tuples (`stack_device_batches`: the det
    targets' per-task lists have other class counts per task and stack
    leaf-wise)."""
    return _tree_map(lambda *xs: np.stack(xs), *batches)


def bn_running_stats(model: nn.Module) -> List[torch.Tensor]:
    """The running mean and variance of every BatchNorm of `model` (the
    sparse ones and torch's), the buffers JAX's `batch_stats` holds."""
    from ..nn.modules import SparseBatchNorm
    out = []
    for m in model.modules():
        if isinstance(m, (SparseBatchNorm, nn.modules.batchnorm._BatchNorm)):
            out += [m.running_mean, m.running_var]
    return out


def replica_tensors(model: nn.Module,
                    metrics: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """What a train step averages over the replicas: every parameter's
    gradient (a zero one where a parameter has none, as optax's trees
    have), the BatchNorm running statistics and the metric values."""
    grads = []
    for p in model.parameters():
        if p.requires_grad and p.grad is None:
            p.grad = torch.zeros_like(p)
        if p.grad is not None:
            grads.append(p.grad)
    return grads + bn_running_stats(model) + list(metrics.values())


def all_reduce_mean(tensors: Sequence[torch.Tensor], group) -> None:
    """Replace each tensor by its mean over the replicas of `group` (JAX's
    `pmean`): one flat all-reduce per dtype, then a division by the world
    size. Every rank gets the same bytes."""
    world = dist.get_world_size(group)
    with record_function(ALL_REDUCE_RANGE), torch.no_grad():
        def mean(flat):
            dist.all_reduce(flat, group=group)
            flat.div_(world)
        _coalesced(tensors, mean)


def shard_step(step_fn: Callable, mesh: DataMesh) -> Callable:
    """Stands for `shard_step` (a per-replica step under shard_map): the
    returned step(model, opt, batches, **kw) runs `step_fn` on this rank's
    batch of the global list `batches`, put on the rank's device
    (`multihost.make_global_batch`), with `group=mesh.group`, through
    which the step averages its gradients (and, with SyncBN, its batch
    statistics)."""
    from .multihost import make_global_batch

    def sharded(model, opt, batches, **kw):
        batch = make_global_batch(mesh, [data_sharded(mesh, batches)])
        return step_fn(model, opt, batch, group=mesh.group, **kw)

    return sharded


class _Collect:
    """An optimizer that takes nothing: the step leaves its gradients in
    place for `sequential_dp_step`."""

    param_groups: list = []

    def zero_grad(self, set_to_none: bool = True) -> None:
        pass

    def step(self) -> None:
        pass


def sequential_dp_step(step_fn: Callable, model: nn.Module, opt,
                       batches: Sequence[Any], lr: Optional[float] = None
                       ) -> Dict[str, torch.Tensor]:
    """The data-parallel step computed in one process (`make_dp_train_step`
    vmaps the per-replica loss over the replicas): `step_fn(model, opt,
    batch)` (`seg_train_step`, `det_train_step`) runs each replica's batch
    in turn from the same parameters and running statistics; then the
    gradients, the updated running statistics and the metrics are averaged
    over the replicas and `opt` steps once. `lr`, when given, is the step's
    learning rate. Returns the averaged metrics."""
    buffers = list(model.buffers())
    start = [t.clone() for t in buffers]
    stats = bn_running_stats(model)
    grads, ends, metrics = [], [], []
    for b in batches:
        with torch.no_grad():
            for t, s in zip(buffers, start):
                t.copy_(s)
        for p in model.parameters():
            p.grad = None
        metrics.append(step_fn(model, _Collect(), b))
        grads.append([torch.zeros_like(p) if p.grad is None else p.grad
                      for p in model.parameters()])
        ends.append([t.clone() for t in stats])
    n = len(batches)
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.grad = sum(g[i] for g in grads) / n
        for i, t in enumerate(stats):
            t.copy_(sum(e[i] for e in ends) / n)
    if lr is not None:
        for group in opt.param_groups:
            group["lr"] = lr
    opt.step()
    return {k: sum(m[k] for m in metrics) / n for k in metrics[0]}
