"""Where a served det frame's time goes on the card, for this checkout or
another.

    python3 link_tpu_torch/tools/serve_split.py [--frames 2] [--rounds 3]
        [--out FILE]
    python3 link_tpu_torch/tools/serve_split.py --tree DIR --whole-postprocess

Builds the det serving path of `chip_smoke.py` (phase det_main): the
bfloat16 CenterPoint-ELKv3 nuScenes `SingleFramePredictor` at the 160k val
capacity with seeded weights, on synthetic nuScenes frames (200,000 points
each). After one warm `predict`, each round times every frame on the host
clock, stage by stage (`split_frame`): voxelize; forward + decode
(synchronized; device NMS included in that mode); the copies to the host,
the host NMS and the score floors; and then a whole `predict`; with host
NMS, then with device NMS.

`--tree DIR` loads `link_tpu_torch` from another checkout (an unpacked `git
archive` of an earlier commit), so that two commits are timed by the same
script on the same card; `--whole-postprocess` is for a checkout whose
predictor has only the stages voxelize, forward and postprocess, and no
device NMS: it times `postprocess` as one stage, with host NMS only.
Prints the card's name and power limit, then one JSON line with the
medians and every reading. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0].strip()


def split_frame(pred, points, whole_postprocess: bool = False):
    """One frame through the predictor's stages, each timed on the host
    clock (the forward synchronized), then a whole `predict`: (the
    detections, {stage: ms}). The postprocess is timed as `masked_rows`
    (copy_ms), `host_nms` and `apply_floors`, or with whole_postprocess as
    `postprocess` (postprocess_ms)."""
    import torch
    if whole_postprocess:
        post = [("postprocess_ms", pred.postprocess)]
    else:
        from link_tpu_torch.inference import masked_rows
        post = [("copy_ms", masked_rows), ("host_nms_ms", pred.host_nms),
                ("floors_ms", pred.apply_floors)]

    def forward(batch):
        outs = pred.forward(batch)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return outs

    split = {}
    x = points
    t0 = time.perf_counter()
    for name, stage in [("voxelize_ms", pred.voxelize),
                        ("forward_ms", forward)] + post:
        t = time.perf_counter()
        x = stage(x)
        split[name] = (time.perf_counter() - t) * 1e3
    split["stages_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pred.predict(points)
    split["predict_ms"] = (time.perf_counter() - t0) * 1e3
    return x, split


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(REPO),
                    help="checkout whose link_tpu_torch is measured")
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, help="JSON file for the result")
    ap.add_argument("--whole-postprocess", action="store_true",
                    help="an older checkout: postprocess as one stage, "
                    "host NMS only")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("serve_split: no CUDA device", file=sys.stderr)
        return 1
    import link_tpu_torch
    from link_tpu_torch import inference
    from link_tpu_torch.data.nuscenes import SyntheticNuScenes
    from link_tpu_torch.ops import kernels

    kernels.build_kernels()
    ds = SyntheticNuScenes(length=args.frames, mode="val", seed=0,
                           max_voxels=160000)
    frames = [ds.points(i) for i in range(args.frames)]
    modes = ["host"] if args.whole_postprocess else ["host", "device"]
    res = {"package": str(Path(link_tpu_torch.__file__).parent),
           "card": card_line(), "torch": torch.__version__, "modes": {}}
    print(res["card"], flush=True)
    for mode in modes:
        kw = {"device_nms": True} if mode == "device" else {}
        pred = inference.SingleFramePredictor(dtype="bfloat16", seed=0,
                                              device="cuda", **kw)
        pred.predict(frames[0])                               # warm-up
        readings = [split_frame(pred, p, args.whole_postprocess)[1]
                    for _ in range(args.rounds) for p in frames]
        med = {k: float(np.median([r[k] for r in readings]))
               for k in readings[0]}
        res["modes"][mode] = {"median": med, "readings": readings}
        print(f"# {mode} NMS, median ms per frame: "
              + ", ".join(f"{k} {v:.3f}" for k, v in med.items()),
              flush=True)
        del pred
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({"package": res["package"], "card": res["card"],
                      **{m: v["median"] for m, v in res["modes"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
