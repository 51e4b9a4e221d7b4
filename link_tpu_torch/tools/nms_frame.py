"""Device time of a det frame's rotated NMS on the card, for this checkout
or another.

    python3 link_tpu_torch/tools/nms_frame.py [--tree DIR [--per-task]]
        [--frames 2] [--rounds 3] [--out FILE]

Builds the det serving model of `chip_smoke.py` (phase det_main: the
bfloat16 CenterPoint-ELKv3 nuScenes `SingleFramePredictor` at the 160k val
capacity, seed 0) and decodes synthetic nuScenes frames. Then, in each
round and for each frame: `frame_nms_timing` of the frame's six candidate
sets (the times that chip_smoke.py's det_nms_kernels phase reports too:
the frame's NMS by graph replay, and each kernel's device ms per launch
from a trace of the real calls); the package's whole `device_nms` (the
candidates' top-k and the kernel), by graph replay; and forward + decode
without device NMS, CUDA events around one synchronized call (the host's
pace included). Also `rotated_nms` launches per frame in one
`device_nms`, and the boxes kept per task.

`--tree DIR` loads `link_tpu_torch` from another checkout (an unpacked `git
archive` of an earlier commit), so that two commits are timed by the same
script on the same card: run parent, change, change, parent. `--per-task`
is for a checkout whose `rotated_nms` takes one candidate set per call: the
frame's NMS is then one call per task. Prints the card's name and power
limit, then one JSON line with the medians. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0].strip()


def frame_sets(cands):
    """The six tasks' candidate sets of one frame (batch row 0), stacked as
    `device_nms` stacks them: boxes (T, k, 5) [x y w l r], scores and
    valid (T, k)."""
    import torch
    return (torch.cat([torch.cat([bx[..., 0:2], bx[..., 3:5], bx[..., 8:9]],
                                 -1) for bx, *_ in cands]),
            torch.cat([sc for _, sc, _, _ in cands]),
            torch.cat([vm for *_, vm in cands]))


def frame_nms_timing(kernels, sets, thresh: float, max_keep: int,
                     per_task: bool = False, iters: int = 20) -> dict:
    """A frame's `rotated_nms` work on the card over `sets` (boxes (S, N, 5),
    scores and valid (S, N)): one call over the S sets, or with per_task
    one call per set. Returns `ms`, the device ms per frame by graph replay
    (`timed_by` says how: `utils.timing.device_ms`), and from a
    torch.profiler trace of `iters` frames `kernel_ms`, each kernel's
    mean device ms per launch by name, and `kernel_launches`, its
    launches per frame in the trace: the launches as they run on the
    path. The trace may drop a launch (a frame's first, when the tracer
    starts late), so a launch's time is the mean over those it holds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from link_tpu_torch.utils.timing import device_ms

    boxes, scores, valid = sets

    def frame():
        if per_task:
            return [kernels.rotated_nms(boxes[t], scores[t], valid[t],
                                        thresh, max_keep)
                    for t in range(scores.shape[0])]
        return kernels.rotated_nms(boxes, scores, valid, thresh, max_keep)

    out = {}
    out["ms"], out["timed_by"] = device_ms(frame, iters)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            frame()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    out["kernel_ms"] = {e.key[:80]: e.self_device_time_total / 1e3 / e.count
                        for e in kern}
    out["kernel_launches"] = {e.key[:80]: e.count / iters for e in kern}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(REPO),
                    help="checkout whose link_tpu_torch is measured")
    ap.add_argument("--per-task", action="store_true",
                    help="the checkout's rotated_nms takes one set per call")
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None, help="JSON file for the result")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("nms_frame: no CUDA device", file=sys.stderr)
        return 1
    import link_tpu_torch
    from link_tpu_torch import inference
    from link_tpu_torch.data.nuscenes import SyntheticNuScenes
    from link_tpu_torch.models.center_head import device_nms, nms_candidates
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.utils.timing import device_ms

    kernels.build_kernels()
    ds = SyntheticNuScenes(length=args.frames, mode="val", seed=0,
                           max_voxels=160000)
    pred = inference.SingleFramePredictor(dtype="bfloat16", seed=0,
                                          device="cuda")
    th = pred.cfg["nms_iou_threshold"]
    post = pred.cfg["nms_post_max_size"]
    batches = [pred.voxelize(ds.points(i)) for i in range(args.frames)]
    outs = [pred.forward(b) for b in batches]
    sets = [frame_sets(nms_candidates(o, pred.cfg)) for o in outs]

    res = {"package": str(Path(link_tpu_torch.__file__).parent),
           "card": card_line(), "torch": torch.__version__,
           "per_task": args.per_task}
    print(res["card"], flush=True)
    kernels.reset_launch_counts()
    for o in outs:
        device_nms(o, pred.cfg)
    torch.cuda.synchronize()
    res["launches_per_frame"] = kernels.rotated_nms.launches / args.frames
    res["kept"] = [[int(k[0].sum()) for *_, k in device_nms(o, pred.cfg)]
                   for o in outs]

    readings = []
    for _ in range(args.rounds):
        for f, (o, s, b) in enumerate(zip(outs, sets, batches)):
            r = dict(frame_nms_timing(kernels, s, th, post, args.per_task,
                                      args.iters), frame=f)
            r["nms_ms"] = r.pop("ms")
            r["device_nms_ms"], mode = device_ms(
                lambda: device_nms(o, pred.cfg), args.iters)
            r["timed_by"] = [r["timed_by"], mode]
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            pred.forward(b)
            end.record()
            end.synchronize()
            r["forward_ms"] = start.elapsed_time(end)
            readings.append(r)
    res["median"] = {k: float(np.median([r[k] for r in readings]))
                     for k in ("nms_ms", "device_nms_ms", "forward_ms")}
    res["median"]["kernel_ms"] = {
        k: float(np.median([r["kernel_ms"].get(k, 0.0) for r in readings]))
        for k in readings[0]["kernel_ms"]}
    res["readings"] = readings
    print("# medians, ms per frame (kernel_ms per launch): "
          + json.dumps(res["median"]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({k: res[k] for k in ("package", "card", "per_task",
                                          "launches_per_frame", "kept",
                                          "median")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
