"""Ranks of the port's data-parallel CPU tests (tests/test_torch_parallel.py,
tests/test_torch_dp_syncbn.py). A spawned rank imports the module of its
function, so this module imports no JAX.

Each function is `fn(rank, world, workdir)` for
`torch.multiprocessing.spawn`: it joins a gloo group through a file in
`workdir`, reads its inputs from `workdir/inputs.pkl` and writes
`workdir/rank<r>.pkl`.
"""

import os
import pickle

import numpy as np
import torch
from torch import nn

from link_tpu_torch import parallel as par
from link_tpu_torch.parallel import multihost as mh


def _join(rank, world, workdir):
    torch.set_num_threads(1)
    mesh = mh.init_mesh("file://" + os.path.join(workdir, "rendezvous"),
                        world, rank, "cpu")
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        return mesh, pickle.load(f)


def _done(rank, workdir, out):
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def spawn(fn, workdir, inputs, world=2):
    """Run `fn` on `world` ranks; returns each rank's output."""
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    torch.multiprocessing.spawn(fn, args=(world, workdir), nprocs=world)
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def gather_rank(rank, world, workdir):
    """allgather_host, gather_detections, process_shard_indices (from
    the group), replicated and data_sharded on this rank's inputs."""
    mesh, inp = _join(rank, world, workdir)
    out = {"mesh": (mesh.rank, mesh.world_size, str(mesh.device)),
           "info": mh.process_info()}
    out["tree"] = mh.allgather_host(inp["trees"][rank])
    out["dets"] = mh.gather_detections(*inp["dets"][rank])
    out["shard"] = mh.process_shard_indices(inp["indices"], 4)
    lin = nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(rank)
    out["replicated"] = par.replicated(mesh, lin).weight.detach().clone()
    out["sharded"] = par.data_sharded(mesh, inp["batches"])
    out["global"] = mh.make_global_batch(mesh, [out["sharded"]])
    _done(rank, workdir, out)


def bn_rank(rank, world, workdir):
    """A SparseBatchNorm and a BatchNorm2d (through `rpn.batch_norm_2d`),
    each synced over the ranks: this rank's output, the gradients of
    sum(output * ct) for its input and the module's parameters, and the
    running statistics after."""
    from link_tpu_torch.models.rpn import batch_norm_2d
    from link_tpu_torch.nn.modules import SparseBatchNorm, sync_batch_norms
    from link_tpu_torch.sparse.tensor import make_sparse_tensor
    mesh, inp = _join(rank, world, workdir)
    out = {}
    feats = torch.tensor(inp["feats"][rank], requires_grad=True)
    c = feats.shape[1]
    sbn = sync_batch_norms(SparseBatchNorm(c), mesh.group)
    with torch.no_grad():
        sbn.weight.copy_(torch.tensor(inp["scale"]))
        sbn.bias.copy_(torch.tensor(inp["bias"]))
    n = len(feats)
    coords = np.stack([np.arange(n), np.zeros(n), np.zeros(n),
                       np.zeros(n)], 1).astype(np.int32)
    st = make_sparse_tensor(feats, coords, nnz=inp["nnz"][rank],
                            device="cpu")
    y = sbn(st).feats
    (y * torch.tensor(inp["ct"][rank])).sum().backward()
    out["sparse"] = {"y": y.detach(), "dx": feats.grad,
                     "dscale": sbn.weight.grad, "dbias": sbn.bias.grad,
                     "mean": sbn.running_mean.clone(),
                     "var": sbn.running_var.clone()}
    x = torch.tensor(inp["x2d"][rank], requires_grad=True)
    dbn = sync_batch_norms(nn.BatchNorm2d(x.shape[1], eps=1e-3,
                                          momentum=0.01), mesh.group)
    with torch.no_grad():
        dbn.weight.copy_(torch.tensor(inp["scale2d"]))
        dbn.bias.copy_(torch.tensor(inp["bias2d"]))
    y = batch_norm_2d(dbn, x)
    (y * torch.tensor(inp["ct2d"][rank])).sum().backward()
    out["dense"] = {"y": y.detach(), "dx": x.grad,
                    "dscale": dbn.weight.grad, "dbias": dbn.bias.grad,
                    "mean": dbn.running_mean.clone(),
                    "var": dbn.running_var.clone(),
                    "tracked": int(dbn.num_batches_tracked)}
    _done(rank, workdir, out)
