"""Data-parallel train steps on several ranks, held against the same step
computed in one process.

    python3 -m link_tpu_torch.tools.dp_check [--nprocs 2] \
        [--device cuda:0|cuda] [--parts seg,det] \
        [--out chiprun_out/dp_check.json]

Each part is a job: a model builder (called with `device` and a seed-0
`generator`; rank 0's weights are broadcast to every rank by
`parallel.replicated`; with "sync_bn" its BatchNorms are synced over the
ranks), an optimizer builder (called with the model), a step
(`seg_train_step` or `det_train_step`) and one batch per replica. The
builders are top-level functions or classes, or `functools.partial`s of
them, which pickle by reference. `run_ranks` spawns the ranks (the `spawn`
start method: a forked CUDA context is unsafe), which take every job in
turn: one data-parallel step from the shared weights, then a step with
every rank given replica 0's batch, then `TIMED_STEPS` more steps and the
all-reduce alone, timed.

The parent (`hold`) computes the first step as
`parallel.sequential_dp_step` (the replicas' batches in turn from the same
state, gradients and running statistics averaged, one update) and the
second as the plain one-device step, each twice, and holds rank 0's step
against them (`compare`): the loss terms; every running statistic; the
averaged gradient by readings that a sign flip of a near-zero entry cannot
move far (`grad_gaps`: the global norm, the relative distance, each leaf's
norm), within `GRAD_FACTOR` times the reference's own gap to its repeat
(`grad_limits`), with planted faults (replica 0's gradient alone, the sum
in place of the mean) that must read outside those limits; and the
parameters, as the reference optimizer's update from the rank's own
gradient. Every rank's parameters must be equal to the bit.

`--device cuda:0` puts every rank on card 0, which takes gloo (NCCL
refuses two ranks on one card): a check of correctness, not of scaling.
`--device cuda` puts rank r on card r, over NCCL. The seg part is ELKUNet
cr1.0 float32 at the 80k cap, one scan a replica; the det part
CenterPoint-ELKv3 float32 at the recipe's 163,840 cap, one frame a
replica, on frames whose every level fits its capacity (a 20 m ground
patch); TF32 is off for the holds. The part "seg_syncbn_remat" (not in
the default parts) runs the seg part's data-parallel step with SyncBN over
the ranks from a model built with remat and without (`nn/remat.py`): the
remat step is held against the plain one as above, within 10x the widest
of two repeats of the plain step, and must make the same all-reduce calls
and kernel launches but the ELK blocks' replayed aggregation
(`remat_launches`, `hold_remat`).
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import math
import os
import pickle
import subprocess
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from ..nn.modules import sync_batch_norms
from ..parallel import (all_reduce_mean, bn_running_stats, data_sharded,
                        replica_tensors, replicated, sequential_dp_step,
                        shard_step)
from ..parallel import multihost as mh

SEG_CONFIG = os.path.join(os.path.dirname(__file__), "..", "..", "configs",
                          "semantic_kitti", "linkunet", "default.yaml")
DET_CAPACITY = 163840         # det_train's --voxel-capacity, one frame
LOSS_TOL = 1e-4               # seg: absolute
DET_LOSS_TOL = 2e-5           # det: relative
STAT_TOL = 1e-5               # of the buffer's largest magnitude
# the gradients' readings: within GRAD_FACTOR x the reference step's gap
# to its own repeat, never tighter than GRAD_FLOOR (a step that repeats to
# the bit, as on the CPU)
GRAD_FACTOR, GRAD_FLOOR = 10.0, 1e-3
# a leaf whose norm is under this share of the global norm (float noise: a
# conv bias ahead of a BatchNorm) is read against that floor
LEAF_FLOOR = 1e-6
# the parameters: the reference optimizer's update from the rank's own
# gradient, within float32 rounding of the leaf's largest magnitude
PARAM_TOL = 1e-6
TIMED_STEPS = 2


def seg_model(config: str, capacities, grid_extent, device, generator,
              remat: bool = False):
    """The config's seg model in float32 (`builder.make_model`)."""
    from ..models import builder
    from ..utils.config import load_config
    return builder.make_model(load_config(config), capacities=capacities,
                              dtype="float32", device=device,
                              generator=generator, grid_extent=grid_extent,
                              remat=remat)


def sgd(model, lr: float, momentum=0.9, weight_decay=1e-4, nesterov=True):
    from ..train.trainer import make_sgd
    return make_sgd(model.parameters(), lr, momentum, weight_decay, nesterov)


def one_cycle_adam(model, lr_max: float, total_steps: int):
    """det_train's recipe: one-cycle Adam, decay 0.01, clip 35."""
    from ..train import det_trainer as DT
    from ..train import schedules
    from .det_train import RECIPE as R
    lr_fn, mom_fn = schedules.one_cycle(
        lr_max, total_steps, moms=R["moms"], div_factor=R["div_factor"],
        pct_start=R["pct_start"])
    return DT.make_one_cycle_adam(model, lr_fn, mom_fn, weight_decay=R["wd"],
                                  grad_clip=R["clip"])


def step_fn(job: Dict):
    """The job's step(model, opt, batch, group=None) -> metrics."""
    if job["step"] == "seg":
        from ..train.trainer import seg_train_step
        return functools.partial(seg_train_step, **job["step_kwargs"])
    from ..train.det_trainer import det_train_step
    return functools.partial(det_train_step, **job["step_kwargs"])


def build(job: Dict, device) -> tuple:
    """(model, optimizer) of a job on `device`."""
    model = job["model"](device=device, generator=torch.Generator()
                         .manual_seed(job["seed"]))
    if job.get("state"):
        model.load_state_dict(torch.load(job["state"]))
    return model, job["optimizer"](model)


def digest(model) -> str:
    """sha1 of every parameter's and buffer's bytes."""
    h = hashlib.sha1()
    for t in list(model.parameters()) + list(model.buffers()):
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def _snapshot(model, metrics) -> Dict:
    return {"state": {k: v.detach().cpu() for k, v in
                      model.state_dict().items()},
            "grads": {k: p.grad.detach().cpu() for k, p in
                      model.named_parameters() if p.grad is not None},
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rank_job(mesh, job: Dict, rank: int, workdir: str) -> Dict:
    """One job on this rank: the held step, the same-batch step, the timed
    steps and the all-reduce alone."""
    from ..ops import kernels
    from ..train.trainer import make_dp_eval_step
    dev = mesh.device
    step = shard_step(step_fn(job), mesh)
    out = {}
    for part, batches in (("dp", job["batches"]),
                          ("same", job["batches"][:1] * mesh.world_size)):
        model, opt = build(job, dev)
        replicated(mesh, model)
        if job.get("sync_bn"):
            sync_batch_norms(model, mesh.group)
        if part == "dp" and job.get("eval_classes"):
            _, counters = make_dp_eval_step(model, mesh, job["eval_classes"])(
                data_sharded(mesh, batches))
            out["eval_counters"] = counters.cpu().numpy().tolist()
        kernels.reset_launch_counts()
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        metrics = step(model, opt, batches)
        _sync(dev)
        out[f"{part}_first_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"{part}_digest"] = digest(model)
        if part == "dp":
            out["launches"] = {f.__name__: f.launches
                               for f in kernels.KERNELS}
        if rank == 0:
            torch.save(_snapshot(model, metrics),
                       os.path.join(workdir, f"{job['name']}_{part}.pt"))
        if part == "dp":
            times = []
            for _ in range(job.get("timed_steps", 0)):
                _sync(dev)
                t0 = time.perf_counter()
                metrics = step(model, opt, batches)
                _sync(dev)
                times.append((time.perf_counter() - t0) * 1e3)
            out["step_ms"] = times
            tensors = replica_tensors(model, metrics)
            out["all_reduce_bytes"] = sum(t.numel() * t.element_size()
                                          for t in tensors)
            ar = []
            for _ in range(3):
                _sync(dev)
                t0 = time.perf_counter()
                all_reduce_mean(tensors, mesh.group)
                _sync(dev)
                ar.append((time.perf_counter() - t0) * 1e3)
            out["all_reduce_ms"] = ar
            if dev.type == "cuda":
                out["peak_mem_gb"] = (torch.cuda.max_memory_allocated(dev)
                                      / 2**30)
        del model, opt
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _rank(rank: int, world: int, backend: str, device: str,
          workdir: str) -> None:
    """A spawned rank: join the group through a file in `workdir`, run the
    jobs of `workdir/jobs.pkl`, write `workdir/rank<r>.json`."""
    with open(os.path.join(workdir, "jobs.pkl"), "rb") as f:
        jobs = pickle.load(f)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mh.init_mesh("file://" + os.path.join(workdir, "rendezvous"),
                        world, rank, device, backend)
    res = {"device": str(mesh.device), "backend": backend,
           "jobs": {job["name"]: (_remat_rank_job if job.get("remat_runs")
                                  else _rank_job)(mesh, job, rank, workdir)
                    for job in jobs}}
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


# a SyncBN remat job's runs on every rank: the step without remat, two
# repeats (their spread sets the gradient limits: the card's atomic sums
# move a leaf by a whole ReLU term in some pairs of runs and not in
# others), the step with remat
REMAT_REPEATS = ("plain_again", "plain_again_2")
REMAT_RUNS = ("plain",) + REMAT_REPEATS + ("remat",)


def _remat_rank_job(mesh, job: Dict, rank: int, workdir: str) -> Dict:
    """A SyncBN job on this rank: the data-parallel step from the shared
    weights with every BatchNorm synced over the ranks, for each of
    REMAT_RUNS (the model built with `remat` for the last); the
    all-reduce calls and kernel launches of each step; rank 0's step
    saved."""
    from ..ops import kernels
    dist = torch.distributed
    step = shard_step(step_fn(job), mesh)
    calls = {"n": 0}
    real = dist.all_reduce

    def all_reduce(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    out = {}
    for run in REMAT_RUNS:
        model = job["model"](device=mesh.device,
                             generator=torch.Generator().manual_seed(
                                 job["seed"]), remat=run == "remat")
        opt = job["optimizer"](model)
        replicated(mesh, model)
        sync_batch_norms(model, mesh.group)
        kernels.reset_launch_counts()
        calls["n"] = 0
        dist.all_reduce = all_reduce
        try:
            _sync(mesh.device)
            if mesh.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(mesh.device)
            t0 = time.perf_counter()
            metrics = step(model, opt, job["batches"])
            _sync(mesh.device)
        finally:
            dist.all_reduce = real
        out[run] = {"ms": (time.perf_counter() - t0) * 1e3,
                    "all_reduce_calls": calls["n"],
                    "launches": {f.__name__: f.launches
                                 for f in kernels.KERNELS},
                    "digest": digest(model)}
        if mesh.device.type == "cuda":
            out[run]["peak_mem_gb"] = (torch.cuda.max_memory_allocated(
                mesh.device) / 2**30)
        if rank == 0:
            torch.save(_snapshot(model, metrics),
                       os.path.join(workdir, f"{job['name']}_{run}.pt"))
        del model, opt
    return out


REMAT_TOL = 1e-5   # remat vs plain step: the loss terms (relative) and
#                    each running statistic (of its buffer's largest); the
#                    forward repeats but for the atomic sums' rounding


def running_stats(state: Dict) -> Dict:
    """The BatchNorms' running statistics of a `state_dict`."""
    return {k: v for k, v in state.items()
            if "running" in k or "num_batches" in k}


def remat_holds(runs: Dict) -> Dict:
    """The remat step against the step without remat, from the readings
    of REMAT_RUNS ({run: {"metrics", "grads", "stats"}}, from the same
    weights on the same batch). Held: the loss terms and every running
    statistic within REMAT_TOL, and `grad_gaps` within `grad_limits` of
    the widest of the plain step's repeats, with the sum for the mean
    planted (it must read outside). Read beside them: the worst gradient
    entry. "failed" names the held readings out of bounds."""
    plain, remat = runs["plain"], runs["remat"]
    repeat = widest([grad_gaps(runs[run]["grads"], plain["grads"])
                     for run in REMAT_REPEATS])
    limits = grad_limits(repeat)
    out = {"loss_err": max(abs(remat["metrics"][k] - v) / max(abs(v), 1e-30)
                           for k, v in plain["metrics"].items()),
           "stats": _worst(remat["stats"], plain["stats"],
                           lambda k, w: float(w.double().abs().max())),
           "grad": _entry_worst(remat["grads"], plain["grads"]),
           "grad_repeat": {k: repeat[k] for k in ("norm", "dist")},
           "grad_share": grad_shares(grad_gaps(remat["grads"],
                                               plain["grads"]), limits),
           "control": grad_shares(grad_gaps(
               {k: 2 * g for k, g in plain["grads"].items()},
               plain["grads"]), limits)}
    out["failed"] = [name for name, bad in (
        ("loss", not out["loss_err"] <= REMAT_TOL),
        ("stats", not out["stats"][0] <= REMAT_TOL),
        ("gradients", not _worst_share(out["grad_share"]) <= 1.0),
        ("gradient hold blind to the sum for the mean",
         not _worst_share(out["control"]) > 1.0)) if bad]
    return out


def remat_launches(plain: Dict[str, int]) -> Dict[str, int]:
    """The kernel launches of a remat step whose step without remat makes
    `plain`: each rematerialized ELK block's replay runs its
    `elk_aggregate` forward again, as many launches as its backward, so
    half as many again (every other kernel's count is the same)."""
    want = dict(plain)
    if "elk_aggregate" in want:
        want["elk_aggregate"] += want["elk_aggregate"] // 2
    return want


def hold_remat(job: Dict, ranks: List[Dict], workdir: str) -> Dict:
    """The parent's side of a SyncBN remat job: rank 0's steps held by
    `remat_holds`; besides, every rank's steps making the same all-reduce
    calls and kernel launches with remat as without, and every rank's
    parameters equal to the bit."""
    runs = {}
    for run in REMAT_RUNS:
        snap = torch.load(os.path.join(workdir, f"{job['name']}_{run}.pt"))
        runs[run] = {"metrics": snap["metrics"], "grads": snap["grads"],
                     "stats": running_stats(snap["state"])}
    out = remat_holds(runs)
    per_rank = [r["jobs"][job["name"]] for r in ranks]
    out["all_reduce_calls"] = [[r[run]["all_reduce_calls"]
                                for run in REMAT_RUNS] for r in per_rank]
    out["ms"] = [[r[run]["ms"] for run in REMAT_RUNS] for r in per_rank]
    out["peak_mem_gb"] = [[r[run].get("peak_mem_gb") for run in REMAT_RUNS]
                          for r in per_rank]
    out["launches"] = per_rank[0]["remat"]["launches"]
    out["failed"] += [name for name, bad in (
        ("all-reduce calls", any(len(set(c)) != 1
                                 for c in out["all_reduce_calls"])),
        ("launches", any(r[run]["launches"] != (
            remat_launches(r["plain"]["launches"]) if run == "remat"
            else r["plain"]["launches"])
            for r in per_rank for run in REMAT_RUNS)),
        ("ranks' parameters differ", any(
            len({r[run]["digest"] for r in per_rank}) != 1
            for run in REMAT_RUNS))) if bad]
    return out


def run_ranks(jobs: List[Dict], nprocs: int, backend: str, device: str,
              workdir: str) -> List[Dict]:
    """Spawn `nprocs` ranks over `jobs`; a rank that fails raises here
    (and the others are stopped). Returns each rank's results."""
    with open(os.path.join(workdir, "jobs.pkl"), "wb") as f:
        pickle.dump(jobs, f)
    torch.multiprocessing.spawn(_rank, args=(nprocs, backend, device,
                                             workdir), nprocs=nprocs)
    out = []
    for r in range(nprocs):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _worst(got: Dict, want: Dict, scale_of) -> tuple:
    """(worst share, its key) of max |got - want| over scale_of(key, want)."""
    worst = (0.0, None)
    for k, w in want.items():
        err = float((got[k].double() - w.double()).abs().max()) / max(
            scale_of(k, w), 1e-30)
        worst = max(worst, (err, k), key=lambda x: x[0])
    return worst


def _entry_worst(got: Dict, want: Dict) -> tuple:
    """The worst gradient entry, of its leaf's largest magnitude; a leaf
    whose largest is below 1e-7 of the largest of all (float noise: the
    bias of a conv that feeds a BatchNorm) of that largest instead, as
    tests/test_torch_det_train_step.py reads them. A near-zero activation
    that lands on the other side of a ReLU moves such an entry, so the card
    reads it beside the gated `grad_gaps`, not as a gate."""
    top = max(float(w.abs().max()) for w in want.values())
    return _worst(got, want, lambda k, w: float(w.abs().max())
                  if float(w.abs().max()) >= 1e-7 * top else top)


def grad_gaps(got: Dict, want: Dict) -> Dict:
    """Gradients `got` against `want` (name -> tensor), in readings that
    one entry of either sign moves only by its share of the whole: "norm",
    the global norms' relative gap; "dist", |got - want| / |want| over
    every leaf; "leaves", each leaf's norms' relative gap, and
    "leaf_dist", each leaf's |got - want| / |want| (a leaf whose norm is
    under LEAF_FLOOR of the global norm read against that floor). The sum
    in place of the mean reads 1 on each; replica 0's gradient in place of
    the replicas' mean reads |g0 - g1| / |g0 + g1| on "dist"."""
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))  # noqa
    wn = {k: norm(w) for k, w in want.items()}
    gn = {k: norm(got[k]) for k in want}
    dn = {k: norm(got[k].double() - w.double()) for k, w in want.items()}
    whole = math.sqrt(sum(v * v for v in wn.values()))
    scale = {k: max(wn[k], LEAF_FLOOR * whole) for k in want}
    return {"norm": abs(math.sqrt(sum(v * v for v in gn.values())) - whole)
            / whole,
            "dist": math.sqrt(sum(v * v for v in dn.values())) / whole,
            "leaves": {k: abs(gn[k] - wn[k]) / scale[k] for k in want},
            "leaf_dist": {k: dn[k] / scale[k] for k in want}}


def grad_limits(repeat: Dict) -> Dict:
    """The `grad_gaps` readings' limits from the reference step's gaps to
    its own repeat: GRAD_FACTOR x the repeat's distance, globally for
    "norm" and "dist" and leaf by leaf for "leaves" (a norm moves by no
    more than the distance, and the distance, a sum over every entry, is
    steadier from run to run than the norm's gap), at least GRAD_FLOOR."""
    lim = lambda v: max(GRAD_FLOOR, GRAD_FACTOR * v)  # noqa: E731
    return {"norm": lim(repeat["dist"]), "dist": lim(repeat["dist"]),
            "leaves": {k: lim(v) for k, v in repeat["leaf_dist"].items()}}


def widest(readings: List[Dict]) -> Dict:
    """Several `grad_gaps` readings merged by their largest value, reading
    by reading and leaf by leaf: the spread of a step's repeats, as
    `grad_limits` takes it."""
    leaf = lambda key: {k: max(r[key][k] for r in readings)  # noqa: E731
                        for k in readings[0][key]}
    return {"norm": max(r["norm"] for r in readings),
            "dist": max(r["dist"] for r in readings),
            "leaves": leaf("leaves"), "leaf_dist": leaf("leaf_dist")}


def grad_shares(gaps: Dict, limits: Dict) -> Dict:
    """Each reading over its limit (over 1: out of bounds); the leaves'
    worst as (share, leaf, gap)."""
    leaf = max(((v / limits["leaves"][k], k, v)
                for k, v in gaps["leaves"].items()), key=lambda x: x[0])
    return {"norm": gaps["norm"] / limits["norm"],
            "dist": gaps["dist"] / limits["dist"], "leaf": leaf}


def _worst_share(shares: Dict) -> float:
    return max(shares["norm"], shares["dist"], shares["leaf"][0])


def _reference(job: Dict, device, part: str) -> Dict:
    """The parent's step from the shared weights: `sequential_dp_step`
    over the replicas ("dp") or the one-device step on replica 0's batch
    ("same"). Returns its metrics, gradients, running statistics, model
    and optimizer."""
    fn = step_fn(job)
    model, opt = build(job, device)
    if part == "dp":
        metrics = sequential_dp_step(fn, model, opt, job["batches"],
                                     lr=job["step_kwargs"].get("lr"))
    else:
        metrics = fn(model, opt, job["batches"][0])
    stats_ids = {id(t) for t in bn_running_stats(model)}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: p.grad.detach().cpu()
                      for k, p in model.named_parameters()},
            "stats": {k: b.detach().cpu() for k, b in model.named_buffers()
                      if id(b) in stats_ids},
            "model": model, "opt": opt}


def _replayed(job: Dict, device, grads: Dict) -> Dict:
    """The job's optimizer from the shared weights, stepped once on
    `grads` at the step's learning rate: the parameters it gives."""
    model, opt = build(job, device)
    for k, p in model.named_parameters():
        p.grad = grads[k].to(device)
    lr = job["step_kwargs"].get("lr")
    if lr is not None:
        for group in opt.param_groups:
            group["lr"] = lr
    opt.step()
    return {k: p.detach().cpu() for k, p in model.named_parameters()}


def _loss_err(job: Dict, got: Dict, want: Dict) -> float:
    """The worst loss term's gap: seg absolute
    (tests/test_torch_train_step.py), det relative (its loss is ~10-100x;
    tests/test_torch_det_train_step.py)."""
    return max(abs(got[k] - v) / (1.0 if job["step"] == "seg"
                                  else max(abs(v), 1e-30))
               for k, v in want.items())


def compare(job: Dict, snap: Dict, ref: Dict, limits: Dict,
            device) -> Dict:
    """Rank 0's step (`snap`) against the parent's (`ref`). Held: the loss
    terms (seg absolute, det relative), every running statistic (of its
    largest), the gradients' `grad_gaps` within `limits`, and every
    parameter against the job's optimizer stepped on rank 0's own gradient
    (`_replayed`; PARAM_TOL of the leaf's largest). Read beside them: the
    worst gradient entry (`_entry_worst`) and, for det, the global norms.
    Returns the readings and, under "failed", the held ones that exceed
    their bounds."""
    loss = _loss_err(job, snap["metrics"], ref["metrics"])
    gaps = grad_gaps(snap["grads"], ref["grads"])
    out = {"loss_err": loss, "grad": _entry_worst(snap["grads"],
                                                  ref["grads"]),
           "grad_gaps": {"norm": gaps["norm"], "dist": gaps["dist"]},
           "grad_share": grad_shares(gaps, limits),
           "stats": _worst(snap["state"], ref["stats"],
                           lambda k, w: float(w.abs().max()))}
    if job["step"] == "det":
        out["grad_norms"] = [math.sqrt(sum(
            float(torch.linalg.vector_norm(t.double())) ** 2
            for t in gs.values())) for gs in (ref["grads"], snap["grads"])]
    want = _replayed(job, device, snap["grads"])
    out["param_share_of_bound"] = _worst(
        snap["state"], want,
        lambda k, w: PARAM_TOL * float(w.abs().max()) + 1e-30)
    out["failed"] = [name for name, (v, bound) in (
        ("loss", (loss, LOSS_TOL if job["step"] == "seg"
                  else DET_LOSS_TOL)),
        ("stats", (out["stats"][0], STAT_TOL)),
        ("gradients", (_worst_share(out["grad_share"]), 1.0)),
        ("params", (out["param_share_of_bound"][0], 1.0)))
        if not v <= bound]
    return out


def hold(job: Dict, ranks: List[Dict], workdir: str, device,
         timed_steps: int = 0) -> Dict:
    """The parent's side of one job. For each part, the reference step
    twice (its gap to its repeat sets the gradients' limits,
    `grad_limits`), rank 0's step against it (`compare`), planted faults
    that must read outside the limits (else the gradient hold is blind
    and "failed" says so), and every rank's parameters equal to the bit;
    the one-device step timed `timed_steps` times."""
    res, grads = {}, {}
    for part in ("same", "dp"):
        ref = _reference(job, device, part)
        if part == "same":
            times = []
            for _ in range(timed_steps):
                _sync(device)
                t0 = time.perf_counter()
                step_fn(job)(ref["model"], ref["opt"], job["batches"][0])
                _sync(device)
                times.append((time.perf_counter() - t0) * 1e3)
            res["one_rank_step_ms"] = times
        del ref["model"], ref["opt"]
        again = _reference(job, device, part)
        del again["model"], again["opt"]
        repeat = grad_gaps(again["grads"], ref["grads"])
        limits = grad_limits(repeat)
        snap = torch.load(os.path.join(workdir, f"{job['name']}_{part}.pt"))
        res[part] = out = compare(job, snap, ref, limits, device)
        out["repeat"] = {
            "loss_err": _loss_err(job, again["metrics"], ref["metrics"]),
            "grad": _entry_worst(again["grads"], ref["grads"]),
            "grad_gaps": {"norm": repeat["norm"], "dist": repeat["dist"]},
            "grad_share": grad_shares(repeat, limits)}
        grads[part] = ref["grads"]
        controls = {"sum for mean": {k: 2 * g for k, g in
                                     ref["grads"].items()}}
        if part == "dp" and len(job["batches"]) > 1:
            controls["replica 0 alone"] = grads["same"]
        out["controls"] = {name: grad_shares(grad_gaps(c, ref["grads"]),
                                             limits)
                           for name, c in controls.items()}
        blind = [name for name, s in out["controls"].items()
                 if not _worst_share(s) > 1.0]
        if blind:
            out["failed"].append(f"gradient hold blind to {blind}")
        digests = {r["jobs"][job["name"]][f"{part}_digest"] for r in ranks}
        if len(digests) != 1:
            out["failed"].append("ranks' parameters differ")
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return res


def seg_job(world: int) -> Dict:
    """ELKUNet cr1.0 float32 from its config at the 80k cap, one synthetic
    scan a replica, SGD at the schedule's first lr for the world."""
    from ..data.collate import collate_scans
    from ..data.semantic_kitti import SyntheticSemanticKITTI, grid_extent
    from ..models import builder
    from ..utils.config import load_config
    cfg = load_config(SEG_CONFIG)
    caps = tuple(cfg.model.capacities)
    ext = grid_extent(cfg.dataset.voxel_size, batch_size=1)
    ds = SyntheticSemanticKITTI(length=world, num_points=80000,
                                n_raw_points=120000, split="train")
    batches = [collate_scans([ds.__getitem__(r, np.random.default_rng(r))],
                             caps[0], grid_extent=ext) for r in range(world)]
    lr = float(builder.make_lr_schedule(cfg, world_size=world)(0))
    o = cfg.optimizer
    return {"name": "seg", "step": "seg", "seed": 0,
            "model": functools.partial(seg_model, SEG_CONFIG, caps, ext),
            "optimizer": functools.partial(
                sgd, lr=lr, momentum=o.momentum,
                weight_decay=o.weight_decay, nesterov=o.nesterov),
            "step_kwargs": {"ignore_label": cfg.criterion.ignore_index,
                            "lr": lr},
            "batches": batches, "timed_steps": TIMED_STEPS,
            "eval_classes": cfg.data.num_classes}


def seg_syncbn_remat_job(world: int) -> Dict:
    """`seg_job` with SyncBN, its model built with and without remat
    (`_remat_rank_job`)."""
    job = seg_job(world)
    job.update(name="seg_syncbn_remat", remat_runs=True, timed_steps=0)
    return job


def fitting_det_frame(seed: int, n_points: int = 150000) -> Dict:
    """A train-mode nuScenes-shaped frame whose every backbone level fits
    the det capacities: `n_points` on a 20 m x 20 m ground patch (the
    synthetic frames' scattered voxels overflow levels 1-3), with the
    synthetic frames' boxes and targets."""
    from ..data import det_pipeline as dp
    from ..data.nuscenes import SyntheticNuScenes
    ds = SyntheticNuScenes(mode="train")
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-10, 10, n_points),
                    rng.uniform(-10, 10, n_points),
                    rng.normal(-1.0, 0.03, n_points),
                    rng.uniform(0, 255, n_points), np.zeros(n_points)],
                   1).astype(np.float32)
    boxes, classes = ds.draw_boxes(rng)
    voxels, coords_zyx, nppv = dp.points_to_voxel(
        pts, ds.voxel_size, ds.pc_range, ds.max_points_in_voxel,
        DET_CAPACITY)
    return {"voxels": voxels, "coords_zyx": coords_zyx, "num_points": nppv,
            "targets": dp.assign_label(
                boxes, classes, pc_range=ds.pc_range,
                voxel_size=ds.voxel_size,
                out_size_factor=ds.out_size_factor)}


def det_job(world: int) -> Dict:
    """CenterPoint-ELKv3 float32 at the recipe's capacities for one frame
    (`det_capacities(163840, 1)`), one fitting frame a replica, det_train's
    one-cycle Adam over a 20-epoch schedule of 4 steps an epoch."""
    from ..data import det_pipeline as dp
    from ..models.scn import det_capacities
    from ..models.voxelnet import VoxelNet
    from .det_train import RECIPE
    caps = det_capacities(DET_CAPACITY, 1)
    batches = [dp.collate_det([fitting_det_frame(r)], DET_CAPACITY)
               for r in range(world)]
    return {"name": "det", "step": "det", "seed": 0,
            "model": functools.partial(VoxelNet, batch_size=1,
                                       capacities=caps),
            "optimizer": functools.partial(
                one_cycle_adam, lr_max=RECIPE["lr_max"],
                total_steps=RECIPE["epochs"] * 4),
            "step_kwargs": {}, "batches": batches,
            "timed_steps": TIMED_STEPS}


def check(parts=("seg", "det"), nprocs: int = 2,
          device: str = "cuda:0") -> Dict:
    """Every part on `nprocs` ranks, held in this process on the card of
    rank 0: gloo where every rank shares one device ("cuda:0", "cpu"),
    NCCL with a card a rank ("cuda"). Returns {part: holds and timings,
    "ranks": per-rank results}."""
    jobs = [{"seg": seg_job, "det": det_job,
             "seg_syncbn_remat": seg_syncbn_remat_job}[p](nprocs)
            for p in parts]
    backend = "nccl" if device == "cuda" else "gloo"
    ref_device = mh.rank_device(device)     # rank 0's
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        ranks = run_ranks(jobs, nprocs, backend, device, workdir)
        out = {"ranks_s": time.perf_counter() - t0, "backend": backend,
               "ranks": ranks}
        for job in jobs:
            out[job["name"]] = (hold_remat(job, ranks, workdir)
                                if job.get("remat_runs") else
                                hold(job, ranks, workdir, ref_device,
                                     TIMED_STEPS))
    # a remat job's holds are one record; the other jobs' one a part
    held = {p: ({p: out[p]} if "failed" in out[p] else
                {f"{p} {part}": out[p][part] for part in ("dp", "same")})
            for p in parts}
    failed = {k: v for h in held.values() for k, v in h.items()
              if v["failed"]}
    if failed:
        raise AssertionError(f"out of bounds: {failed}; all: "
                             f"{ {p: out[p] for p in parts} }")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:N: every rank on card N over gloo; cuda: "
                         "rank r on card r over NCCL")
    ap.add_argument("--parts", default="seg,det")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("dp_check runs on CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = check(tuple(args.parts.split(",")), args.nprocs, args.device)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    print("\n".join(out["card"]), flush=True)
    for part in args.parts.split(","):
        r = out[part]
        if "dp" not in r:
            print(f"{part}: {r}", flush=True)
            continue
        print(f"{part}: dp {r['dp']}, same batch {r['same']}; one-rank "
              f"step ms {r['one_rank_step_ms']}; per rank: "
              + "; ".join(f"{x['device']} step ms "
                          f"{x['jobs'][part]['step_ms']}, all-reduce ms "
                          f"{x['jobs'][part]['all_reduce_ms']} of "
                          f"{x['jobs'][part]['all_reduce_bytes']} B"
                          for x in out["ranks"]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
