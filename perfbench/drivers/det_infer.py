"""One client in a closed loop over the port's det_test double-flip path:
each frame's four flipped voxelizations as one batch through the runner's
`forward` (model, fused decode, device NMS) and `detections` (the kept
boxes to the host), frame after frame from a pool.

Set-up: the pool (ray-cast 10-sweep frames, each voxelized four times and
collated by the port's own det pipeline, as a loader's workers would), the
row audit of every flip's levels, the runner with weights drawn on the
device from the seed and its norms' statistics from the reference, and a
warm-up. The window hands the pool's frames in turn; a frame's latency is
from handing its batch to the runner to its boxes on the host. The check
after the window, on frames of the pool drawn from the seed (the last
window call of each): the heads' outputs against the plain reference's
float32 forward from the raw points; the reference's fused decode of the
port's own head outputs against the port's candidates; the reference's
rotated NMS over the port's candidates against the port's keep.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import harness
from perfbench.count import peaks, work
from perfbench.reference import centerpoint as ref
from perfbench.reference import sparse as S
from perfbench.scenes import audit, raycast

WARM_FRAMES = 3
TRACED_FRAMES = 4
CHECKED_FRAMES = 3


def make_pool(run: harness.Run, dev) -> List[np.ndarray]:
    tr = run.cell["traffic"]
    return [raycast.nusc_frame(raycast.item_seed(run.seed, i), tr, dev)["points"]
            for i in range(tr["pool_frames"])]


def port_batches(points: List[np.ndarray], cfg: Dict, runner):
    """Each frame voxelized with its three flips by the port's pipeline and
    collated by the runner; the level rows of every flip."""
    from link_tpu_torch.data import det_pipeline as dp
    from link_tpu_torch.data.nuscenes import make_double_flip_variants
    args = (cfg["voxel_size"], cfg["pc_range"], cfg["max_points_in_voxel"],
            cfg["max_voxels"])
    batches, rows = [], []
    for p in points:
        voxels, coords_zyx, nppv = dp.points_to_voxel(p, *args)
        s = {"voxels": voxels, "coords_zyx": coords_zyx, "num_points": nppv,
             "flip_variants": make_double_flip_variants(p, *args)}
        batches.append(runner.batch(s))
        for v in [s] + s["flip_variants"]:
            rows.append(audit.det_rows(torch.as_tensor(np.concatenate(
                [v["coords_zyx"][:, ::-1], np.zeros((len(v["coords_zyx"]), 1),
                                                    np.int32)], 1)),
                cfg["grid"]))
    return batches, rows


def check_rows(rows: List[List[int]], cfg: Dict) -> None:
    caps = cfg["capacities_per_frame"]
    worst = [max(r[l] for r in rows) for l in range(len(caps))]
    harness.log(f"row audit over {len(rows)} flipped frames: most rows by "
                f"level {worst} against capacities a frame {caps} (voxels "
                f"at most {cfg['max_voxels']})")
    over = [l for l in range(len(caps)) if worst[l] > caps[l]]
    if over or worst[0] >= cfg["max_voxels"]:
        raise RuntimeError(f"rows would be dropped at levels {over} (or the "
                           "voxelizer's cap was reached)")


def build(cfg, seed: int, points0: np.ndarray, dev):
    """The port's runner, the weights (parameters and the norms'
    statistics) drawn from the seed, and the seconds of the reference's
    statistics pass, which set-up does not count."""
    from link_tpu_torch.tools import det_test
    args = det_test.parse_args(["--double-flip", "--dtype", cfg["dtype"],
                                "--device-nms", "--device", str(dev)])
    runner = det_test.DetTest(args, str(dev))
    weights = harness.draw_weights(ref.param_spec(), seed, dev)
    t_stats = time.perf_counter()
    coords, feats = ref.batch_inputs(points0, cfg, dev)
    with torch.no_grad():
        ref.Net(weights, collect=True, grid=cfg["grid"],
                block=cfg["block_sz"], r=cfg["elk_r"]).forward(coords, feats, 4)
    del coords, feats
    if dev.type == "cuda":
        # the statistics pass is the benchmark's: the memory peak is the
        # program's from here on
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    stats_s = time.perf_counter() - t_stats
    sd = runner.model.state_dict()
    missing = set(sd) - set(weights)
    if set(weights) - set(sd) or any(not k.endswith("num_batches_tracked")
                                     for k in missing):
        raise RuntimeError("the model's state differs from the reference's: "
                           + str(sorted(set(sd) ^ set(weights)))[:2000])
    runner.model.load_state_dict({**{k: sd[k] for k in missing}, **weights},
                                 strict=True)
    return runner, weights, stats_s


def run(run: harness.Run, device: str = "cuda", fault=None) -> None:
    from link_tpu_torch.inference import masked_rows
    from link_tpu_torch.ops import kernels
    dev = torch.device(device)
    cfg = run.cell["config"]
    run.mark("imports done")
    points = make_pool(run, dev)
    run.mark("pool done")
    runner, weights, stats_s = build(cfg, run.seed, points[0], dev)
    run.mark("runner and weights done")
    if runner.cap != 4 * cfg["capacities_per_frame"][0]:
        raise RuntimeError(f"the runner's capacity {runner.cap} is not four "
                           "frames' capacity")
    batches, rows = port_batches(points, cfg, runner)
    check_rows(rows, cfg)
    run.mark("voxelized pool and row audit done")
    held = {"on": False, "heads": None}

    def hook(_mod, _inp, out):
        if held["on"]:
            held["heads"] = out

    runner.model.bbox_head.register_forward_hook(hook)
    state = {"runner": runner, "batches": batches}
    if fault is not None:
        fault(state)

    def frame(i: int):
        out = state["runner"].forward(batches[i % len(batches)])
        return out, state["runner"].detections(masked_rows(out))

    for i in range(WARM_FRAMES):
        frame(i)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    # the reference's statistics pass is the benchmark's, not set-up's
    run.setup_s = time.perf_counter() - run.t_start - stats_s
    harness.log(f"set-up {run.setup_s:.2f} s (the statistics pass's "
                f"{stats_s:.2f} s left out); pool of {len(batches)} frames, "
                f"{[int(b['nnz']) for b in batches]} rows of 4 flips")

    rng = np.random.default_rng(raycast.item_seed(run.seed, 7_000_000))
    sample = set(rng.choice(len(batches), CHECKED_FRAMES, replace=False)
                 .tolist())
    kept: Dict[int, Dict] = {}
    lat, handed, failed = [], [0] * len(batches), 0
    nxt = WARM_FRAMES
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        b = nxt % len(batches)
        held["on"] = b in sample
        t_hand = time.perf_counter()
        out, det = frame(nxt)
        lat.append(time.perf_counter() - t_hand)
        held["on"] = False
        failed += int(not np.isfinite(det[0]).all())
        if b in sample:
            kept[b] = {"heads": held["heads"], "out": out, "det": det}
        handed[b] += 1
        nxt += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    win_s = time.perf_counter() - t0
    frames = len(lat)
    # a sampled frame the window did not reach goes through the same call
    # after it, so that every run compares its sample
    for b in sorted(sample - set(kept)):
        held["on"] = True
        out, det = frame(b)
        held["on"] = False
        kept[b] = {"heads": held["heads"], "out": out, "det": det}
    run.attempted = frames
    run.failed = failed
    window_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    run.memory_peak = max(setup_peak, window_peak) if dev.type == "cuda" else 0
    run.window = {"infer_samples_per_s": frames / win_s,
                  "latency_p95_ms": harness.p95(lat) * 1e3,
                  "peak_mem_gb": window_peak / 1e9}
    harness.log(f"window {win_s:.3f} s: {frames} frames, "
                f"{run.window['infer_samples_per_s']:.3f} frames/s, latency "
                f"median {float(np.median(lat)) * 1e3:.2f} ms, p95 "
                f"{run.window['latency_p95_ms']:.2f} ms ({frames} frames), "
                f"peak {window_peak / 1e9:.3f} GB; frames handed {handed}")

    if run.trace:
        from perfbench import trace
        count = {"n": 0}

        def traced_frames():
            kernels.reset_launch_counts()
            for _ in range(TRACED_FRAMES):
                frame(nxt + count["n"])
                count["n"] += 1

        if dev.type == "cuda":
            run.red = trace.traced_complete(
                traced_frames, lambda: kernels.sorted_join.launches, harness.log)
        peak = peaks.peak_flops(cfg["dtype"])
        tot = {}
        for b in range(len(batches)):
            c = torch.as_tensor(batches[b]["coords"][:int(batches[b]["nnz"])],
                                device=dev)
            tot[b] = work.totals(work.centerpoint_infer_calls(
                c, cfg["grid"], 4), peak, peaks.HBM_BYTES_PER_S)
        first = nxt + count["n"] - TRACED_FRAMES
        run.info.update(
            samples_traced=TRACED_FRAMES, window_s=win_s, peak_flops=peak,
            window_flops=sum(tot[b]["flops"] * n for b, n in enumerate(handed)),
            traced_conv_least_s=sum(tot[(first + j) % len(batches)]
                                    ["conv_least_s"]
                                    for j in range(TRACED_FRAMES)),
            join_ranges=("sparse/join_site", "sparse/join_inputs"))
        harness.log(f"counted work {tot[0]['flops'] / 1e9:.1f} GFLOP a frame "
                    f"(pool frame 0); the card "
                    f"{peaks.power_limit() if dev.type == 'cuda' else 'n/a'}")

    del state, runner, batches
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    got = check_frames(kept, points, weights, cfg, dev)
    lim = cfg["limits"]
    for k in ("head_gap", "decode_gap", "nms_mismatch"):
        run.check(k, got[k], lim[k])


def head_gap(port_heads, ref_heads) -> float:
    """Worst over tasks and branches of |port - ref| / |ref| (Frobenius)."""
    worst = 0.0
    for pt, rt in zip(port_heads, ref_heads):
        for k, v in rt.items():
            d = (pt[k].float() - v).norm() / v.norm().clamp(min=1e-30)
            worst = max(worst, float(d))
    return worst


def decode_stage(port_heads, port_out, cfg) -> Dict:
    """The reference's fused decode of the port's head outputs against the
    port's candidates, and the reference's NMS over the port's candidates
    against the port's keep."""
    tc = cfg["test_cfg"]
    mine = ref.decode(port_heads, tc)
    gap, diff, kept = 0.0, 0, 0
    for t, (bx, sc, lb, keep) in enumerate(port_out):
        bx, sc, lb, keep = bx[0].float(), sc[0].float(), lb[0], keep[0]
        rb, rs, rl, rv = ref.candidates(mine[t], tc["nms_pre_max_size"])
        valid = rv
        # the candidates' scores in rank order, then every kept box against
        # the reference candidate of its label nearest to it
        n = int(valid.sum())
        if n:
            gap = max(gap, float((rs[:n] - sc[:n]).abs().max()))
        for i in torch.nonzero(keep).squeeze(1).tolist():
            same = rl == lb[i]
            d = torch.where(same, (rb[:, :2] - bx[i, :2]).norm(dim=1),
                            torch.full_like(rs, math.inf))
            j = int(d.argmin())
            delta = (rb[j] - bx[i]).abs()
            delta[8] = abs(math.remainder(float(rb[j, 8] - bx[i, 8]),
                                          2 * math.pi))
            gap = max(gap, float(delta.max()))
        # NMS over the port's own candidates
        bev = torch.cat([bx[:, 0:2], bx[:, 3:5], bx[:, 8:9]], 1)
        vm = sc > 0
        want = ref.rotated_nms(bev, sc, vm, tc["nms_iou_threshold"],
                               tc["nms_post_max_size"])
        diff += int((want != keep.bool()).sum())
        kept += int(want.sum())
    return {"decode_gap": gap, "nms_diff": diff, "kept": kept}


def reference_heads(points: np.ndarray, weights, cfg, dev,
                    prec: S.Precision = S.EXACT):
    coords, feats = ref.batch_inputs(points, cfg, dev)
    with torch.no_grad():
        return ref.Net(weights, prec=prec, grid=cfg["grid"],
                       block=cfg["block_sz"], r=cfg["elk_r"]).forward(
                           coords, feats, 4)


def check_frames(kept: Dict[int, Dict], points, weights, cfg, dev,
                 wanted: Dict = None) -> Dict:
    """The three numbers over the sampled frames (the worst of each);
    `wanted` holds reference heads already computed, by frame."""
    hg, dg, diff, total = 0.0, 0.0, 0, 0
    for b, k in sorted(kept.items()):
        want = (wanted or {}).get(b)
        if want is None:
            want = reference_heads(points[b], weights, cfg, dev)
        hg = max(hg, head_gap(k["heads"], want))
        st = decode_stage(k["heads"], k["out"], cfg)
        dg = max(dg, st["decode_gap"])
        diff += st["nms_diff"]
        total += max(st["kept"], 1)
        del want
    out = {"head_gap": hg, "decode_gap": dg,
           "nms_mismatch": diff / max(total, 1), "frames": sorted(kept)}
    harness.log(f"check over frames {sorted(kept)}: {out}")
    return out


def calibrate(run: harness.Run, device: str = "cuda") -> Dict:
    """The readings behind the limits on this run's seed: the port's heads
    against the reference's on two pool frames, the control (the reference
    with its products' operands in float8 e4m3, per-tensor scaled) against
    the reference, and the decode and NMS stages with an answer altered
    (the kept boxes shifted by one cell) and with NMS left out."""
    from link_tpu_torch.inference import masked_rows
    dev = torch.device(device)
    cfg = run.cell["config"]
    points = make_pool(run, dev)[:2]
    runner, weights, _ = build(cfg, run.seed, points[0], dev)
    batches, rows = port_batches(points, cfg, runner)
    check_rows(rows, cfg)
    held = {}
    runner.model.bbox_head.register_forward_hook(
        lambda m, i, o: held.__setitem__("heads", o))
    kept = {}
    for b in range(len(points)):
        out = runner.forward(batches[b])
        runner.detections(masked_rows(out))
        kept[b] = {"heads": held["heads"], "out": out}
    wanted = {b: reference_heads(points[b], weights, cfg, dev) for b in kept}
    out = {"seed": run.seed, "program": check_frames(kept, points, weights,
                                                     cfg, dev, wanted)}
    fp8 = S.Precision("fp8")
    out["control_fp8"] = {"head_gap": max(head_gap(
        reference_heads(points[b], weights, cfg, dev, fp8), wanted[b])
        for b in kept)}
    shifted, no_nms = {}, {}
    for b, k in kept.items():
        moved = [(bx.clone(), sc, lb, keep) for bx, sc, lb, keep in k["out"]]
        for bx, *_ in moved:
            bx[..., 0] += cfg["test_cfg"]["out_size_factor"] * cfg[
                "voxel_size"][0]
        shifted[b] = {"heads": k["heads"], "out": moved}
        no_nms[b] = {"heads": k["heads"],
                     "out": [(bx, sc, lb, sc > 0) for bx, sc, lb, _ in k["out"]]}
    out["answer_altered"] = {k: v for k, v in check_frames(
        shifted, points, weights, cfg, dev, wanted).items()
        if k != "head_gap"}
    out["nms_left_out"] = {k: v for k, v in check_frames(
        no_nms, points, weights, cfg, dev, wanted).items() if k != "head_gap"}
    return out
