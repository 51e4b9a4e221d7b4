"""Multi-process data-parallel plumbing.

PyTorch counterpart of `link_tpu/parallel/multihost.py`. JAX joins its
processes with `jax.distributed.initialize()` into one global mesh; here
each process is one replica on one device, joined by
`torch.distributed.init_process_group` (NCCL between cards, gloo on the
CPU, and gloo for several ranks on one card, which NCCL refuses). What is
left per process is the same as in JAX:

  * this process's rows of each epoch (`process_shard_indices`, the
    DistributedSampler's rank slice, reference
    `detection/det3d/datasets/loader/sampler.py:16-64`);
  * this process's batch on its device (`make_global_batch`);
  * gathering metrics and detections on the host (`allgather_host`,
    `gather_detections`; reference `detection/tools/dist_test.py:189`).

On one process every function takes the same path with a world of one.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import DataMesh, _tree_map, make_data_mesh


def maybe_initialize(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "gloo") -> int:
    """Join the process group when several processes are asked for; a
    no-op otherwise. Returns this process's rank (0 on one process).

    Explicit arguments win: `coordinator` is `host:port` (TCP rendezvous
    at rank 0) or an init URL (`file:///path`, `tcp://...`). Otherwise
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
    decides. A world of one, or neither, stays a single process. A
    rendezvous that fails raises: nothing falls back to one process."""
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if num_processes is None and (coordinator is not None
                                  or process_id is not None):
        raise ValueError("--coordinator / --process-id need "
                         "--num-processes")
    world = (num_processes if num_processes is not None
             else int(env.get("WORLD_SIZE", 1)))
    if world <= 1:
        if world < 1 or process_id not in (None, 0):
            raise ValueError(f"process {process_id} of a world of {world}")
        return 0
    rank = process_id if process_id is not None else env.get("RANK")
    if coordinator is None and "MASTER_ADDR" in env:
        coordinator = "env://"     # torchrun's store, MASTER_ADDR:PORT
    if rank is None or coordinator is None:
        raise ValueError(f"a world of {world} processes needs this "
                         "process's id (--process-id or RANK) and the "
                         "coordinator (--coordinator or MASTER_ADDR)")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=world,
                            rank=int(rank))
    return dist.get_rank()


def process_info() -> tuple:
    """(rank, world size) of this process."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(spec="cuda") -> torch.device:
    """This rank's device: "cuda" is `cuda:{LOCAL_RANK}` (torchrun's), or
    `cuda:{rank % cards}` without it; "cuda:N" and "cpu" are taken as they
    are. A CUDA device on a machine without one raises."""
    device = torch.device(spec)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {spec}: no CUDA device; pass "
                               "--device cpu to run on the CPU")
        if device.index is None:
            local = os.environ.get("LOCAL_RANK")
            index = (int(local) if local is not None
                     else process_info()[0] % torch.cuda.device_count())
            device = torch.device("cuda", index)
    return device


def default_backend(device: torch.device) -> str:
    """NCCL between cards, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def add_dist_args(ap) -> None:
    """The multi-process flags of the training tools (argparse)."""
    ap.add_argument("--coordinator", default=None,
                    help="multi-process: rank 0's host:port, or an init URL "
                         "(file:///path, tcp://host:port); torchrun's "
                         "MASTER_ADDR / MASTER_PORT without it")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="nccl on cuda, gloo on cpu by default")


def init_mesh(coordinator: Optional[str] = None,
              num_processes: Optional[int] = None,
              process_id: Optional[int] = None, device="cuda",
              backend: Optional[str] = None) -> DataMesh:
    """`maybe_initialize` (the backend by default NCCL on cuda, gloo on the
    CPU), then this rank's `DataMesh` with its device made current."""
    maybe_initialize(coordinator, num_processes, process_id,
                     backend=backend or default_backend(torch.device(device)))
    mesh = make_data_mesh(device)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    return mesh


def init_from_args(args) -> DataMesh:
    """`init_mesh` from a training tool's `add_dist_args` flags and
    `--device`; prints each rank's device and backend."""
    mesh = init_mesh(args.coordinator, args.num_processes, args.process_id,
                     args.device, args.dist_backend)
    print(f"rank {mesh.rank} of {mesh.world_size}: device {mesh.device}"
          + (f", backend {dist.get_backend()}" if mesh.group is not None
             else ""), flush=True)
    return mesh


def process_shard_indices(indices: np.ndarray, samples_per_step: int,
                          process_index: Optional[int] = None,
                          process_count: Optional[int] = None) -> np.ndarray:
    """This process's rows of an epoch's (already shuffled) index order.

    Equivalent to the reference DistributedSampler's rank slice
    (sampler.py:54-60): pad to a whole number of global steps, then take
    a contiguous per-process block of each step's `samples_per_step`
    window so every process sees the same number of steps.
    """
    rank, world = process_info()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    per_proc = samples_per_step // pc
    if samples_per_step % pc:
        raise ValueError(
            f"global batch {samples_per_step} not divisible by "
            f"process count {pc}")
    nsteps = len(indices) // samples_per_step
    indices = indices[:nsteps * samples_per_step].reshape(
        nsteps, pc, per_proc)
    return indices[:, pi, :].reshape(-1)


def local_mesh_devices(mesh: DataMesh) -> List[torch.device]:
    """This process's devices in mesh order: its one device."""
    return [mesh.device]


def make_global_batch(mesh: DataMesh, per_dev_batches: Sequence[Any]) -> Any:
    """This process's part of the global batch: its one per-device host
    batch (a tree of arrays; other leaves stay as they are), every array
    as a tensor on the rank's device. The other replicas' rows stay on
    their processes, as JAX's addressable shards do."""
    local = local_mesh_devices(mesh)
    if len(per_dev_batches) != len(local):
        raise ValueError(f"{len(per_dev_batches)} per-device batches for "
                         f"{len(local)} local mesh devices")

    def put(leaf):
        if isinstance(leaf, (np.ndarray, np.generic, torch.Tensor)):
            return torch.as_tensor(leaf).to(mesh.device)
        return leaf

    return _tree_map(put, per_dev_batches[0])


def _gather_leaf(a, world: int) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    # gloo gathers CPU tensors, NCCL CUDA ones; neither takes bool
    device = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    t = torch.from_numpy(a.view(np.uint8) if a.dtype == np.bool_ else a)
    t = t.to(device)
    out = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(out, t)
    got = torch.stack(out).cpu().numpy()
    return got.view(np.bool_) if a.dtype == np.bool_ else got


def allgather_host(x: Any) -> Any:
    """Gather a (nested) numeric tree from every process onto every host,
    leading axis = process. Every process gives leaves of the same shapes.
    On one process the leading axis is added."""
    world = process_info()[1]
    if world == 1:
        return _tree_map(lambda a: np.asarray(a)[None], x)
    return _tree_map(lambda a: _gather_leaf(a, world), x)


def gather_detections(sample_ids: np.ndarray, boxes: np.ndarray,
                      scores: np.ndarray, labels: np.ndarray,
                      counts: np.ndarray):
    """Multi-process gather of per-sample detection arrays (the reference
    all_gathers python dicts, dist_test.py:189; here the numeric payload
    is packed and gathered as arrays; string tokens resolve from
    sample_ids on the host).

    All inputs are this process's padded arrays:
      sample_ids (S,), boxes (S, D, 9), scores (S, D), labels (S, D),
      counts (S,) — D = per-sample detection cap.
    Returns the same tuple concatenated over processes.
    """
    packed = allgather_host(dict(ids=sample_ids, boxes=boxes, scores=scores,
                                 labels=labels, counts=counts))
    cat = {k: np.concatenate(list(v), axis=0) for k, v in packed.items()}
    return (cat["ids"], cat["boxes"], cat["scores"], cat["labels"],
            cat["counts"])
