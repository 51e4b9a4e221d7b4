"""Back-to-back detection training steps through the port's
`train.det_trainer.det_train_step`, on a pool of augmented ray-cast
10-sweep frames: the model `tools/det_train` builds (`make_model`) and its
one-cycle Adam.

Set-up: the pool (ray-cast frames with the ego driving, the published
train augmentation (flips on both axes, a global rotation, scale and
translation, shuffled points), voxelized at the voxel cap, each frame's
targets from its keyframe boxes by the port's det pipeline, collated as a
loader's workers would), the model with its optimizer, the row audit of
every pool batch against the model's own level capacities (before any
step, so that a program whose capacities would drop rows stops here), the
weights drawn on the device from the seed, then the first steps through
the timed call (steps 1-3 on pool batches 0-2, whose results the reference
checks) and a few more as warm-up. The window then steps on through the
pool. The check after the window: each of the first three losses, the
first gradient, and each parameter's change over the three steps, against
the plain reference's three steps from the same weights on the same
frames; and the rows the program's capacities dropped, which must be none.
Of those numbers the loss gap and the median leaf's gradient gap are
checked; the worst leaf's gradient and change gaps are logged (the
configuration's `not_checked` says why).
"""

from __future__ import annotations

import time
from bisect import bisect_right
from typing import Dict, List

import numpy as np
import torch

from perfbench import harness
from perfbench.count import peaks, work
from perfbench.drivers.seg_train import compare
from perfbench.reference import centerpoint as ref
from perfbench.reference import centerpoint_train as reft
from perfbench.reference import sparse as S
from perfbench.scenes import audit, raycast
from perfbench.spans import CONV, LOSS, merged

CHECKED = ("loss_gap", "grad_median_gap")
LOGGED = ("grad_gap", "grad_leaf", "change_gap", "change_leaf")
CHECKED_STEPS = 3
WARM_STEPS = 3
TRACED_STEPS = 3
CONV_KERNELS = ("gather_conv_kernel", "window_conv_kernel",
                "gather_wgrad_kernel", "w_frag_kernel", "wgrad_reduce_kernel")


def make_frames(run: harness.Run, dev, n_batches: int = None) -> List[Dict]:
    """The pool's frames, augmented: per frame its points (N, 5), boxes
    (M, 9) and classes (0-based nuScenes class indices)."""
    from link_tpu_torch.data import det_pipeline as dp
    tr = run.cell["traffic"]
    n = (n_batches or tr["pool_batches"]) * tr["frames_per_step"]
    frames = []
    for i in range(n):
        f = raycast.nusc_frame(raycast.item_seed(run.seed, i), tr, dev)
        rng = np.random.default_rng(raycast.item_seed(run.seed, 1_000_000 + i))
        points, boxes = dp.global_augment(
            f["points"], f["gt_boxes"], rng,
            rot_noise=tuple(tr["global_rot_noise"]),
            scale_noise=tuple(tr["global_scale_noise"]),
            translate_std=tr["global_translate_std"])
        if tr["shuffle_points"]:
            rng.shuffle(points)
        frames.append({"points": points, "boxes": boxes,
                       "classes": f["gt_classes"]})
    return frames


def port_sample(frame: Dict, cfg: Dict) -> Dict:
    """What the port's train loader makes of a frame: the hard voxels at
    the voxel cap and the CenterPoint targets (`assign_label`)."""
    from link_tpu_torch.data import det_pipeline as dp
    a = cfg["assigner"]
    voxels, coords_zyx, nppv = dp.points_to_voxel(
        frame["points"], cfg["voxel_size"], cfg["pc_range"],
        cfg["max_points_in_voxel"], cfg["max_voxels"])
    tg = dp.assign_label(frame["boxes"], frame["classes"] + 1,
                         pc_range=cfg["pc_range"],
                         voxel_size=cfg["voxel_size"],
                         out_size_factor=a["out_size_factor"],
                         gaussian_overlap=a["gaussian_overlap"],
                         max_objs=a["max_objs"], min_radius=a["min_radius"])
    return {"voxels": voxels, "coords_zyx": coords_zyx, "num_points": nppv,
            "targets": tg}


def level_rows(coords: torch.Tensor, grid, s: int) -> Dict[str, List[int]]:
    """The rows of each backbone level of a batch (the voxels, then each
    strided down's output set), of the extra z conv's output, and the
    ELK aux cells of each level (floor(coords / s))."""
    shape = (grid[0], grid[1], grid[2] + 1)
    c = coords.to(torch.int64)
    rows, aux = [], []
    for lvl in range(4):
        if lvl:
            k, st, pad = audit.DET_DOWNS[lvl - 1]
            c, shape = audit.spconv_out(c, k, st, pad, shape)
        rows.append(int(c.shape[0]))
        a = c.clone()
        a[:, :3] = torch.div(a[:, :3], s, rounding_mode="floor")
        aux.append(int(S.unique_rows(a)[0].shape[0]))
    extra, _ = audit.spconv_out(c, (1, 1, 3), (1, 1, 2), (0, 0, 0), shape)
    return {"rows": rows, "aux": aux, "extra": int(extra.shape[0])}


def check_rows(per_batch: List[Dict], caps) -> List[int]:
    """Every level's rows and aux cells, and the extra conv's rows (level
    3's capacity), against the model's capacities; stops the run when a
    row would be dropped. Returns the worst rows by level."""
    worst = [max(b["rows"][l] for b in per_batch) for l in range(4)]
    worst_aux = [max(b["aux"][l] for b in per_batch) for l in range(4)]
    worst_extra = max(b["extra"] for b in per_batch)
    harness.log(f"row audit over {len(per_batch)} batches: most rows by "
                f"level {worst} (extra conv {worst_extra}), most aux cells "
                f"{worst_aux}, against the model's capacities {list(caps)}")
    over = [l for l in range(4) if worst[l] > caps[l]
            or worst_aux[l] > caps[l]]
    if worst_extra > caps[3]:
        over.append(3)
    if over:
        raise RuntimeError(f"rows would be dropped at levels "
                           f"{sorted(set(over))}: the capacities "
                           f"{list(caps)} do not hold the pool")
    return worst


def pool_batches(run, dev, n_batches: int = None):
    """The frames, their collated batches and the model with its
    optimizer; the row audit against the model's capacities before any
    step, then the model's capacities against the configuration's."""
    from link_tpu_torch.data import det_pipeline as dp
    from link_tpu_torch.tools import det_train
    cfg, tr = run.cell["config"], run.cell["traffic"]
    per = tr["frames_per_step"]
    args = det_train.parse_args([
        "--samples-per-device", str(per), "--voxel-capacity",
        str(cfg["capacities_per_frame"][0]), "--dtype", cfg["dtype"],
        "--device", str(dev)])
    model = det_train.make_model(args, tuple(cfg["grid"]), dev)
    caps = model.backbone.capacities
    frames = make_frames(run, dev, n_batches)
    groups = [frames[b * per:(b + 1) * per]
              for b in range(len(frames) // per)]
    samples = [[port_sample(f, cfg) for f in g] for g in groups]
    voxels = [len(s["voxels"]) for g in samples for s in g]
    harness.log(f"voxels a frame {min(voxels)}-{max(voxels)}, "
                f"{sum(v >= cfg['max_voxels'] for v in voxels)} of "
                f"{len(voxels)} frames at the cap {cfg['max_voxels']}")
    batches = [dp.collate_det(g, caps[0]) for g in samples]
    rows = [level_rows(torch.as_tensor(b["coords"][:int(b["nnz"])],
                                       device=dev), cfg["grid"],
                       cfg["block_sz"]) for b in batches]
    check_rows(rows, caps)
    listed = [c * per for c in cfg["capacities_per_frame"]]
    if list(caps) != listed:
        raise RuntimeError(f"the model's capacities {list(caps)} are not "
                           f"the configuration's {listed} (capacities_per_"
                           f"frame x frames_per_step)")
    return groups, batches, model, make_opt(model, cfg)


def make_opt(model, cfg):
    """`det_train`'s one-cycle Adam, held at the configuration's lr and
    beta1."""
    from link_tpu_torch.train import det_trainer as DT
    return DT.make_one_cycle_adam(
        model, lambda count: cfg["lr"], lambda count: cfg["beta1"],
        weight_decay=cfg["weight_decay"], grad_clip=cfg["grad_clip"])


def load_weights(model, seed: int, dev) -> Dict[str, torch.Tensor]:
    """The parameters and norm buffers drawn from the seed, loaded into the
    model (also returned, for the reference)."""
    weights = harness.draw_weights(ref.param_spec(), seed, dev)
    sd = model.state_dict()
    missing = set(sd) - set(weights)
    if set(weights) - set(sd) or any(not k.endswith("num_batches_tracked")
                                     for k in missing):
        raise RuntimeError("the model's state differs from the reference's: "
                           + str(sorted(set(sd) ^ set(weights)))[:2000])
    model.load_state_dict({**{k: sd[k] for k in missing}, **weights},
                          strict=True)
    return weights


def first_steps(step, params):
    """Steps 1-3 through `step(i)`: the losses, the first gradient and
    each parameter's change over the three."""
    p0 = {k: v.detach().clone() for k, v in params.items()}
    losses, grad1 = [], {}
    for i in range(CHECKED_STEPS):
        losses.append(float(step(i)["loss"]))
        if i == 0:
            grad1 = {k: (p.grad.detach().clone() if p.grad is not None
                         else torch.zeros_like(p)) for k, p in params.items()}
    change = {k: v.detach() - p0[k] for k, v in params.items()}
    return losses, grad1, change


def reference_readings(groups, weights, cfg, dev,
                       prec: S.Precision = S.EXACT, frames: int = None):
    """The reference's three steps from `weights` on pool batches 0-2 (of
    each batch its first `frames` frames, or all)."""
    batches = []
    for g in groups[:CHECKED_STEPS]:
        g = g[:frames] if frames else g
        batches.append({"points": [f["points"] for f in g],
                        "targets": reft.stack_targets(
                            [reft.targets(f["boxes"], f["classes"], cfg)
                             for f in g], dev)})
    losses, grad, after = reft.train_steps(
        weights, batches, cfg, cfg["lr"], cfg["beta1"], cfg["weight_decay"],
        cfg["grad_clip"], prec)
    return {"losses": losses, "grad": grad,
            "change": {k: after[k] - weights[k] for k in after}}


def _program_readings(model, opt, batches, step_fn=None):
    """`first_steps` of the program (or of `step_fn`, a fault) on the
    batches."""
    from link_tpu_torch.train.det_trainer import det_train_step
    step_fn = step_fn or det_train_step
    params = dict(model.named_parameters())
    return dict(zip(("losses", "grad", "change"), first_steps(
        lambda i: step_fn(model, opt, batches[i % len(batches)]), params)))


def _conv_spans_hold(red) -> Dict:
    """The conv kernels' records launched inside and outside the `conv/*`
    spans, and the records of `window_conv` and `elk_aggregate`."""
    spans = merged(red, CONV)
    starts = [a for a, _ in spans]
    inside = outside = 0
    for ts, _, name in red["ops"]:
        if ts is None or not any(k in name for k in CONV_KERNELS):
            continue
        i = bisect_right(starts, ts) - 1
        if i >= 0 and ts < spans[i][1]:
            inside += 1
        else:
            outside += 1
    return {"conv_kernels_in_conv_spans": inside,
            "conv_kernels_outside": outside,
            "window_conv": sum(n for k, n in red["launches"].items()
                               if "window_conv_kernel" in k),
            "elk_aggregate": sum(n for k, n in red["launches"].items()
                                 if "elk_aggregate" in k)}


def _longest_in(red, names, n: int = 5) -> List:
    """The `n` longest device operations launched inside the spans named
    in `names`, as (ms, name)."""
    spans = merged(red, names)
    starts = [a for a, _ in spans]
    inside = []
    for ts, s, name in red["ops"]:
        i = bisect_right(starts, ts) - 1 if ts is not None else -1
        if i >= 0 and ts < spans[i][1]:
            inside.append((round(s * 1e3, 4), name[:80]))
    return sorted(inside, reverse=True)[:n]


def run(run: harness.Run, device: str = "cuda", fault=None) -> None:
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.train.det_trainer import det_train_step

    dev = torch.device(device)
    cfg, tr = run.cell["config"], run.cell["traffic"]
    per = tr["frames_per_step"]
    run.mark("imports done")
    groups, batches, model, opt = pool_batches(run, dev)
    run.mark("pool, model and row audit done")
    weights = load_weights(model, run.seed, dev)
    run.mark("weights done")
    params = dict(model.named_parameters())
    state = {"model": model, "opt": opt, "batches": batches,
             "step": det_train_step}
    if fault is not None:
        fault(state)

    def step(i: int):
        return state["step"](model, opt, batches[i % len(batches)])

    losses, grad1, change = first_steps(step, params)
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
    win_s = time.perf_counter() - t0
    run.attempted = steps * per
    last_loss = float(last["loss"])
    run.failed = 0 if np.isfinite(last_loss) else run.attempted
    window_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    run.memory_peak = max(setup_peak, window_peak) if dev.type == "cuda" else 0
    run.window = {"train_samples_per_s": steps * per / win_s,
                  "peak_mem_gb": window_peak / 1e9}
    harness.log(f"window {win_s:.3f} s: {steps} steps, "
                f"{run.window['train_samples_per_s']:.3f} frames/s, last loss "
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
            harness.log(f"conv spans: {_conv_spans_hold(run.red)}")
            harness.log(f"longest ops in loss/*: {_longest_in(run.red, LOSS)}")
        peak = peaks.peak_flops(cfg["dtype"])
        no_dgrad = ("conv_input",) + tuple(f"elk{l}.pos_weight"
                                           for l in range(1, 5))
        tot = {}
        for b, batch in enumerate(batches):
            c = torch.as_tensor(batch["coords"][:int(batch["nnz"])],
                                device=dev)
            tot[b] = work.totals(work.with_backward(
                work.centerpoint_infer_calls(c, cfg["grid"], per), no_dgrad),
                peak, peaks.HBM_BYTES_PER_S)
        first = nxt + count["n"] - TRACED_STEPS
        run.info.update(
            samples_traced=TRACED_STEPS * per, window_s=win_s,
            peak_flops=peak,
            window_flops=sum(tot[b]["flops"] * n for b, n in enumerate(handed)),
            traced_conv_least_s=sum(tot[(first + j) % len(batches)]
                                    ["conv_least_s"]
                                    for j in range(TRACED_STEPS)),
            join_ranges=("sparse/join_site", "sparse/join_inputs"),
            forward_range="det_train/forward",
            backward_range="det_train/backward")
        harness.log(f"counted work {tot[0]['flops'] / 1e9:.1f} GFLOP a step "
                    f"(pool batch 0); the card "
                    f"{peaks.power_limit() if dev.type == 'cuda' else 'n/a'}")

    dropped = model.rows_dropped()
    harness.log(f"rows dropped by level: {list(dropped)}")
    # the check, once the program's state is freed
    del state, model, opt, last, params
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    prog = {"losses": losses, "grad": grad1, "change": change}
    got = compare(prog, reference_readings(groups, weights, cfg, dev))
    lim = cfg["limits"]
    for k in CHECKED:
        run.check(k, got[k], lim[k])
    harness.log(f"not checked: {({k: got[k] for k in LOGGED})}")
    run.check("rows_dropped", sum(dropped), lim["rows_dropped"])


def _unchanged_step(model, opt, batch):
    """The fault of a step that leaves the state unchanged: the gradient
    is computed, the update skipped."""
    from link_tpu_torch.train.det_trainer import det_train_step
    saved = opt.step
    opt.step = lambda *a, **k: None
    try:
        return det_train_step(model, opt, batch)
    finally:
        opt.step = saved


def calibrate(run: harness.Run, device: str = "cuda") -> Dict:
    """The readings behind the limits, on this run's seed: the program's
    first three steps against the reference; the control (the reference
    with its products' operands in float8 e4m3, per-tensor scaled), the
    half-batch fault (the reference on each step's first frame only) and
    the unchanged-state fault (the program with the update skipped), each
    against the reference."""
    dev = torch.device(device)
    cfg = run.cell["config"]
    groups, batches, model, opt = pool_batches(run, dev, CHECKED_STEPS)
    weights = load_weights(model, run.seed, dev)
    prog = _program_readings(model, opt, batches)
    dropped = model.rows_dropped()
    load_weights(model, run.seed, dev)
    unchanged = _program_readings(model, make_opt(model, cfg), batches,
                                  _unchanged_step)
    del model, opt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_readings(groups, weights, cfg, dev)
    out = {"seed": run.seed,
           "program": dict(compare(prog, want, "program "),
                           rows_dropped=sum(dropped)),
           "control_fp8": compare(reference_readings(
               groups, weights, cfg, dev, S.Precision("fp8")), want,
               "control "),
           "half_batch": compare(reference_readings(
               groups, weights, cfg, dev, frames=1), want, "half batch "),
           "unchanged_state": compare(unchanged, want, "unchanged state ")}
    return out
