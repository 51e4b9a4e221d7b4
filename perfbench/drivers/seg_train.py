"""Back-to-back segmentation training steps through the port's
`train.trainer.seg_train_step`, on a pool of augmented ray-cast scans.

Set-up: the pool (ray-cast scans, the published augmentation, quantized
and collated as a loader's workers would), the row audit, the model and
its optimizer with weights drawn on the device from the seed, then the
first steps through the timed call (steps 1-3 on pool batches 0-2, whose
results the reference checks) and a few more as warm-up. The window then
steps on through the pool. The check after the window: each of the first
three losses, the first gradient as the optimizer got it (its momentum
buffer after one step, less the weight decay), and each parameter's change
over the three steps, against the plain reference's three steps from the
same weights on the same scans.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import harness
from perfbench.count import peaks, work
from perfbench.reference import linkunet as ref
from perfbench.reference import sparse as S
from perfbench.scenes import audit, raycast, voxelize

CHECKED_STEPS = 3
WARM_STEPS = 3
TRACED_STEPS = 3


def make_pool(run: harness.Run, dev, n_batches: int = None) -> List[Dict]:
    """Per batch: the scans (numpy) of one step; the traffic's pool, or its
    first `n_batches`."""
    tr = run.cell["traffic"]
    per = tr["scans_per_step"]
    n_batches = n_batches or tr["pool_batches"]
    scans = []
    for i in range(n_batches * per):
        raw = raycast.kitti_scan(raycast.item_seed(run.seed, i), tr, dev)
        rng = np.random.default_rng(raycast.item_seed(run.seed, 1_000_000 + i))
        scans.append(voxelize.train_sample(raw, tr["voxel_size_m"],
                                           tr["points_per_scan"], rng))
    return [scans[b * per:(b + 1) * per] for b in range(n_batches)]


def ref_batch(scans, dev) -> Dict[str, torch.Tensor]:
    coords = np.concatenate([np.concatenate(
        [s["coords"], np.full((len(s["coords"]), 1), b, np.int32)], 1)
        for b, s in enumerate(scans)])
    return {"coords": torch.as_tensor(coords, device=dev, dtype=torch.int64),
            "feats": torch.as_tensor(np.concatenate([s["feats"] for s in scans]),
                                     device=dev),
            "labels": torch.as_tensor(np.concatenate([s["labels"]
                                                      for s in scans]),
                                      device=dev, dtype=torch.int64)}


def leaf_gaps(prog: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep=None) -> Dict:
    """Worst leaf's gap of norms | |a| - |b| | over the larger of |b| and
    the median leaf's |b|."""
    names = [k for k in want if keep is None or k in keep]
    nb = {k: float(want[k].double().norm()) for k in names}
    na = {k: float(prog[k].double().norm()) for k in names}
    med = float(np.median(list(nb.values())))
    gaps = {k: abs(na[k] - nb[k]) / max(nb[k], med, 1e-30) for k in names}
    worst = max(gaps, key=gaps.get)
    return {"gap": gaps[worst], "leaf": worst,
            "median_gap": float(np.median(list(gaps.values())))}


def compare(prog: Dict, refr: Dict, label: str = "") -> Dict:
    """The three numbers of a training cell, program against reference."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                        refr["losses"]))
    med_g = float(np.median([float(v.norm()) for v in refr["grad"].values()]))
    # leaves the reference barely moves drift under the optimizer by
    # round-off: out of the change, by the reference's first gradient
    keep = {k for k, v in refr["grad"].items()
            if float(v.norm()) >= 1e-3 * med_g}
    g = leaf_gaps(prog["grad"], refr["grad"])
    ch = leaf_gaps(prog["change"], refr["change"], keep)
    out = {"loss_gap": loss_gap, "first_loss_gap": abs(
        prog["losses"][0] - refr["losses"][0]) / abs(refr["losses"][0]),
           "grad_gap": g["gap"], "grad_leaf": g["leaf"],
           "grad_median_gap": g["median_gap"],
           "change_gap": ch["gap"], "change_leaf": ch["leaf"],
           "change_median_gap": ch["median_gap"],
           "left_out": sorted(set(refr["grad"]) - keep)}
    harness.log(f"{label}check: {out}")
    return out


def build(cfg, seed: int, caps, dev):
    """The port's model and optimizer, with the weights drawn from the
    seed (also returned, for the reference)."""
    from link_tpu_torch.models.linkunet import ELKUNet
    from link_tpu_torch.train.trainer import make_sgd
    model = ELKUNet(num_classes=cfg["num_classes"], cr=cfg["cr"], r=cfg["r"],
                    s=cfg["s"], groups=cfg["groups"], baseop=cfg["base_op"],
                    in_channels=cfg["in_channels"], capacities=caps,
                    dtype=cfg["dtype"], device=dev)
    spec = ref.param_spec(cfg["cr"], cfg["in_channels"], cfg["num_classes"])
    weights = harness.draw_weights(spec, seed, dev)
    params = dict(model.named_parameters())
    if set(params) != set(weights) or any(
            params[k].shape != weights[k].shape for k in weights):
        raise RuntimeError("the model's parameters differ from the "
                           "reference's: " + str(sorted(set(params)
                                                        ^ set(weights))))
    with torch.no_grad():
        for k, v in weights.items():
            params[k].copy_(v)
    opt = make_sgd(model.parameters(), lr=cfg["lr"], momentum=cfg["momentum"],
                   weight_decay=cfg["weight_decay"])
    return model, opt, weights


def first_steps(step, opt, params, cfg):
    """Steps 1-3 through `step(i)`: the losses, the first gradient as the
    optimizer got it (momentum buffer less the weight decay) and each
    parameter's change over the three."""
    p0 = {k: v.detach().clone() for k, v in params.items()}
    losses, grad1 = [], {}
    for i in range(CHECKED_STEPS):
        losses.append(float(step(i)["loss"]))
        if i == 0:
            wd = cfg["weight_decay"]
            for k, p in params.items():
                buf = opt.state.get(p, {}).get("momentum_buffer")
                grad1[k] = (buf - wd * p0[k]) if buf is not None else \
                    torch.zeros_like(p0[k])
    change = {k: v.detach() - p0[k] for k, v in params.items()}
    return losses, grad1, change


def pool_batches(run, dev, n_batches: int = None):
    """The pool, its collated batches, the row audit."""
    from link_tpu_torch.data.collate import collate_scans
    cfg, tr = run.cell["config"], run.cell["traffic"]
    per = tr["scans_per_step"]
    caps = tuple(int(c) * per for c in cfg["capacities_per_scan"])
    pool = make_pool(run, dev, n_batches)
    batches = [collate_scans(scans, caps[0], ignore_label=cfg["ignore_label"])
               for scans in pool]
    rows = [audit.seg_rows(ref_batch(s, dev)["coords"], cfg["s"])
            for s in pool]
    audit.check_seg(rows, caps, harness.log)
    return pool, batches, caps


def run(run: harness.Run, device: str = "cuda", fault=None) -> None:
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.train.trainer import seg_train_step

    dev = torch.device(device)
    cfg, tr = run.cell["config"], run.cell["traffic"]
    per = tr["scans_per_step"]
    run.mark("imports done")
    pool, batches, caps = pool_batches(run, dev)
    run.mark("pool and row audit done")

    model, opt, weights = build(cfg, run.seed, caps, dev)
    run.mark("model and weights done")
    params = dict(model.named_parameters())
    state = {"model": model, "opt": opt, "batches": batches,
             "step": seg_train_step}
    if fault is not None:
        fault(state)

    def step(i: int):
        return state["step"](model, opt, batches[i % len(batches)])

    losses, grad1, change = first_steps(step, opt, params, cfg)
    run.mark("checked steps done")
    for i in range(CHECKED_STEPS, CHECKED_STEPS + WARM_STEPS):
        step(i)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - run.t_start
    harness.log(f"set-up {run.setup_s:.2f} s; losses of steps 1-3 {losses}")

    # the window
    nxt = CHECKED_STEPS + WARM_STEPS
    handed = [0] * len(batches)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while time.perf_counter() - t0 < run.seconds:
        handed[nxt % len(batches)] += 1
        last = step(nxt)
        nxt += 1
        steps += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    win_s = t1 - t0
    run.attempted = steps * per
    last_loss = float(last["loss"])
    run.failed = 0 if np.isfinite(last_loss) else run.attempted
    window_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    run.memory_peak = max(setup_peak, window_peak) if dev.type == "cuda" else 0
    run.window = {"train_samples_per_s": steps * per / win_s,
                  "peak_mem_gb": window_peak / 1e9}
    harness.log(f"window {win_s:.3f} s: {steps} steps, "
                f"{run.window['train_samples_per_s']:.3f} scans/s, last loss "
                f"{last_loss:.4f}, peak {window_peak / 1e9:.3f} GB; pool "
                f"batches handed {handed}")

    if run.trace:
        from perfbench import trace
        count = {"n": 0}

        def traced_steps():
            kernels.reset_launch_counts()
            for _ in range(TRACED_STEPS):
                step(count["n"] + nxt)
                count["n"] += 1

        if dev.type == "cuda":
            run.red = trace.traced_complete(
                traced_steps, lambda: kernels.sorted_join.launches, harness.log)
        # the counted work of the window's and the traced steps' batches
        calls = {}
        for b in range(len(batches)):
            calls[b] = work.totals(work.linkunet_train_calls(
                ref_batch(pool[b], dev)["coords"], cfg),
                peaks.peak_flops(cfg["dtype"]), peaks.HBM_BYTES_PER_S)
        window_flops = sum(calls[b]["flops"] * n for b, n in enumerate(handed))
        first_traced = nxt + count["n"] - TRACED_STEPS
        traced_ids = [(first_traced + j) % len(batches)
                      for j in range(TRACED_STEPS)]
        run.info.update(
            samples_traced=TRACED_STEPS * per, window_s=win_s,
            window_flops=window_flops,
            peak_flops=peaks.peak_flops(cfg["dtype"]),
            traced_conv_least_s=sum(calls[b]["conv_least_s"]
                                    for b in traced_ids),
            join_ranges=("sparse/join_site", "sparse/join_inputs"),
            forward_range="seg_train/forward",
            backward_range="seg_train/backward")
        harness.log(f"counted work: {window_flops / 1e12:.4f} TFLOP in the "
                    f"window; the power limit "
                    f"{peaks.power_limit() if dev.type == 'cuda' else 'n/a'}")

    # the check, once the program's state is freed
    del state, model, opt, last
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    prog = {"losses": losses, "grad": grad1, "change": change}
    want = reference_readings(pool, weights, cfg, dev)
    got = compare(prog, want)
    lim = cfg["limits"]
    for k in ("loss_gap", "grad_gap", "grad_median_gap", "change_gap"):
        run.check(k, got[k], lim[k])


def reference_readings(pool, weights, cfg, dev,
                       prec: S.Precision = S.EXACT,
                       dtype=torch.float32) -> Dict:
    """The reference's three steps from `weights` on pool batches 0-2."""
    batches = [ref_batch(pool[i], dev) for i in range(CHECKED_STEPS)]
    for b in batches:
        b["feats"] = b["feats"].to(dtype)
    losses, grad, after = ref.train_steps(
        weights, batches, CHECKED_STEPS, cfg["lr"], cfg["momentum"],
        cfg["weight_decay"], prec)
    return {"losses": losses, "grad": grad,
            "change": {k: after[k] - weights[k] for k in weights}}


def _half(scans):
    """The first half of a step's scans: the fault of a step that leaves
    half its batch out and takes the mean over the rest."""
    return scans[:max(1, len(scans) // 2)]


def calibrate(run: harness.Run, device: str = "cuda") -> Dict:
    """The readings behind the limits, on this run's seed: the program's
    first three steps against the reference, the control (the reference
    with its products' operands rounded to TF32) against the reference,
    the reference in float64 against the reference (how far the numbers
    move from rounding alone), and the half-batch fault (the reference on
    each step's first scan only) against the reference."""
    from link_tpu_torch.train.trainer import seg_train_step
    dev = torch.device(device)
    cfg, tr = run.cell["config"], run.cell["traffic"]
    pool, batches, caps = pool_batches(run, dev, CHECKED_STEPS)
    model, opt, weights = build(cfg, run.seed, caps, dev)
    params = dict(model.named_parameters())
    prog = dict(zip(("losses", "grad", "change"), first_steps(
        lambda i: seg_train_step(model, opt, batches[i]), opt, params, cfg)))
    del model, opt, params
    torch.cuda.empty_cache()
    want = reference_readings(pool, weights, cfg, dev)
    out = {"seed": run.seed,
           "program": compare(prog, want, "program "),
           "control_tf32": compare(reference_readings(
               pool, weights, cfg, dev, S.Precision("tf32")), want, "control "),
           "half_batch": compare(reference_readings(
               [_half(p) for p in pool], weights, cfg, dev), want,
               "half batch ")}
    w64 = {k: v.double() for k, v in weights.items()}
    r64 = reference_readings(pool, w64, cfg, dev, dtype=torch.float64)
    out["float64_look"] = compare(
        {k: ({n: t.float() for n, t in v.items()} if isinstance(v, dict)
             else v) for k, v in r64.items()}, want, "float64 ")
    return out
