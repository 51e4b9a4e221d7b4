"""Device time, host time and launches of the join sites on the card.

    python3 link_tpu_torch/tools/join_sites.py [--tree DIR] [--out FILE]
        [--dcn-repeats N]

A join site is everything that builds one kernel map's join: forming the
queries (base coordinates plus the tap offsets), the `sorted_join` launch,
and for the window form the base rows' pinning and the slots. The port
wraps each site in the profiler range `JOIN_RANGE` (sparse/coords.py:
`join_taps`, `window_join`, `CoordTable.query`; `build_spconv_plan`
through `join_taps`). The script runs one seg pass (4 scans), one det pass
(2 frames) and one training step under torch.profiler, as `chip_smoke.py`
drives them, and prints per scan, frame and step: the ranges' host ms, the
device ms of the kernels and copies launched inside them, those launches,
and the sites entered, with whether the trace holds every `sorted_join`
launch (chip_smoke's `_join_trace`). `--dcn-repeats N` adds N profiles of
chip_smoke's det_dcn pass (2 frames), each read the same way.

`--tree DIR` loads `link_tpu_torch` from another checkout (an unpacked
`git archive` of an earlier commit). Where that package has no ranges of
its own, the script wraps its site functions (`coords.join_taps`,
`coords.window_rows`, `CoordTable.query`, `spconv_engine.
build_spconv_plan`) in the same range, the outermost call only, so that
before and after are read the same way. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
JOIN_RANGE = "sparse/join_site"


def range_stats(prof, name: str, n_items: int) -> dict:
    """Per item, over the outermost `name` ranges of a finished
    torch.profiler run: their host ms; the device operations (kernels,
    copies, fills) launched inside them, counted and their device ms
    summed; and the ranges entered. A device operation belongs to a range
    when the runtime call that launched it (matched by CUPTI's correlation
    id) or the operator it ran for started inside the range on its thread:
    a kernel launched through ctypes has no operator of its own, so
    PyTorch's per-operator device totals miss it."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    spans = sorted((e.start_ns(), e.end_ns(), e.start_thread_id())
                   for e in events
                   if e.name() == name and e.device_type() == DeviceType.CPU)
    outer = []
    for span in spans:
        if not outer or span[0] >= outer[-1][1] or span[2] != outer[-1][2]:
            outer.append(span)

    def inside(e):
        t, th = e.start_ns(), e.start_thread_id()
        return any(a <= t < b and th == thread for a, b, thread in outer)

    runtime, ops = set(), set()
    for e in events:
        if e.device_type() != DeviceType.CPU or e.name() == name:
            continue
        if inside(e):
            (runtime if e.name().startswith("cu") else ops).add(
                e.correlation_id())
    # a host range's annotation on the device's timeline (the name of a
    # record_function range) is no device operation
    host_names = {e.name() for e in events
                  if e.device_type() == DeviceType.CPU}
    dev_ns = 0
    launches = 0
    kinds = {}
    for e in events:
        if e.device_type() == DeviceType.CPU or e.name() in host_names:
            continue
        if e.correlation_id() in runtime or e.linked_correlation_id() in ops:
            dev_ns += e.duration_ns()
            launches += 1
            kinds[e.name()[:80]] = kinds.get(e.name()[:80], 0) + 1
    return {"host_ms": sum(b - a for a, b, _ in outer) / 1e6 / n_items,
            "device_ms": dev_ns / 1e6 / n_items,
            "launches": launches / n_items, "sites": len(outer) / n_items,
            "kinds": {k: v / n_items for k, v in
                      sorted(kinds.items(), key=lambda kv: -kv[1])}}


def wrap_sites() -> bool:
    """Wrap the site functions of a package without ranges of its own in
    JOIN_RANGE (outermost call only). Returns True when it wrapped."""
    from torch.profiler import record_function
    from link_tpu_torch.sparse import coords, spconv_engine
    if hasattr(coords, "JOIN_RANGE"):
        return False
    depth = threading.local()

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*a, **kw):
            if getattr(depth, "n", 0):
                return fn(*a, **kw)
            depth.n = 1
            try:
                with record_function(JOIN_RANGE):
                    return fn(*a, **kw)
            finally:
                depth.n = 0
        return inner

    coords.join_taps = wrap(coords.join_taps)
    coords.window_rows = wrap(coords.window_rows)
    coords.CoordTable.query = wrap(coords.CoordTable.query)
    spconv_engine.build_spconv_plan = wrap(spconv_engine.build_spconv_plan)
    return True


def _profile(run, n_items: int, cs) -> dict:
    from link_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    prof = cs._traced(run)
    out = range_stats(prof, JOIN_RANGE, n_items)
    out["sorted_join_calls"] = kernels.sorted_join.launches / n_items
    out["trace"] = cs._join_trace(prof, kernels.sorted_join.launches)
    return out


def _dcn_profiles(cs, repeats: int) -> list:
    """`repeats` profiles of chip_smoke's det_dcn pass (the bf16
    CenterPoint-ELKv3 with the DCN head, seed-0 weights, forward + decode +
    device NMS over 2 det frames), each read per pass."""
    import torch
    from link_tpu_torch.data import det_pipeline as dp
    from link_tpu_torch.inference import DEFAULT_TEST_CFG
    from link_tpu_torch.models.center_head import decode_boxes, device_nms
    from link_tpu_torch.models.scn import det_capacities
    from link_tpu_torch.models.voxelnet import VoxelNet
    from link_tpu_torch.tools import det_test
    model = VoxelNet(batch_size=1, grid_shape=det_test.GRID,
                     capacities=det_capacities(det_test.CAPACITY, 1),
                     dtype="bfloat16", dcn_head=True, device="cuda",
                     generator=torch.Generator().manual_seed(0)).eval()
    cfg = dict(DEFAULT_TEST_CFG)
    batches = [cs._det_frame(i)[1] for i in range(2)]

    def run():
        with torch.inference_mode():
            for b in batches:
                device_nms(decode_boxes(model(*dp.det_inputs(b, "cuda")),
                                        cfg, model.bbox_head.num_classes),
                           cfg)
    run()
    return [_profile(run, 1, cs) for _ in range(repeats)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(REPO),
                    help="checkout whose link_tpu_torch is measured")
    ap.add_argument("--out", default=None, help="JSON file for the result")
    ap.add_argument("--dcn-repeats", type=int, default=0,
                    help="also profile chip_smoke's det_dcn pass this many "
                         "times")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("join_sites: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import link_tpu_torch
    from link_tpu_torch.data.semantic_kitti import NUM_CLASSES, grid_extent
    from link_tpu_torch.inference import SingleFramePredictor
    from link_tpu_torch.models import builder
    from link_tpu_torch.models.linkunet import DEFAULT_CAPACITIES, ELKUNet
    from link_tpu_torch.ops import kernels
    from link_tpu_torch.train import trainer as T
    from link_tpu_torch.utils.config import load_config

    wrapped = wrap_sites()
    res = {"package": str(Path(link_tpu_torch.__file__).parent),
           "wrapped": wrapped, "card": cs.card_line(),
           "torch": torch.__version__}
    cs.log(f"join_sites: {res['package']} (sites wrapped by this script: "
           f"{wrapped}); {res['card']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build_kernels()

    # seg inference: bf16 ELKUNet cr1.0, 4 scans (chip_smoke phase_main)
    ext = grid_extent(0.05, batch_size=1)
    scans = [cs._scan_tensor(i, "cuda") for i in range(4)]
    model = ELKUNet(num_classes=NUM_CLASSES, cr=1.0,
                    capacities=DEFAULT_CAPACITIES, dtype="bfloat16",
                    grid_extent=ext, device="cuda",
                    generator=torch.Generator().manual_seed(0))
    model.eval()

    def fresh(st):
        return st.replace(cmaps={st.stride: (st.coords, st.nnz)}, kmaps={})

    with torch.inference_mode():
        model(fresh(scans[0]))
        inputs = [fresh(st) for st in scans]
        res["seg_per_scan"] = _profile(lambda: [model(x) for x in inputs],
                                       len(scans), cs)
    del model, scans, inputs

    # det serving: bf16 SingleFramePredictor, 2 frames (phase_det_main)
    batches = [cs._det_frame(i)[1] for i in range(2)]
    pred = SingleFramePredictor(dtype="bfloat16", seed=0, device="cuda")
    pred.forward(batches[0])
    res["det_per_frame"] = _profile(
        lambda: [pred.forward(b) for b in batches], len(batches), cs)
    del pred

    # seg training: f32, batch 2, the config's recipe (phase_train_main)
    cfg = load_config(cs.SEG_CONFIG)
    caps = tuple(2 * c for c in cfg.model.capacities)
    ext2 = grid_extent(0.05, batch_size=2)
    tb = cs._train_batches(2, caps[0], ext2)
    tmodel = builder.make_model(cfg, capacities=caps, dtype="float32",
                                device="cuda", grid_extent=ext2,
                                generator=torch.Generator().manual_seed(0))
    lr = builder.make_lr_schedule(cfg)
    opt = builder.make_optimizer(cfg, tmodel.parameters(), lr(0))

    def step(it):
        return T.seg_train_step(tmodel, opt, tb[it % 2], lr=lr(it),
                                ignore_label=cfg.criterion.ignore_index)

    step(0)
    res["train_per_step"] = _profile(lambda: step(1), 1, cs)
    if args.dcn_repeats:
        res["dcn_per_pass"] = _dcn_profiles(cs, args.dcn_repeats)
        for i, r in enumerate(res["dcn_per_pass"]):
            cs.log(f"dcn pass {i}: {r['sites']:.0f} join ranges, "
                   f"{r['kinds']}; the trace {r['trace']}")

    for key in ("seg_per_scan", "det_per_frame", "train_per_step"):
        r = res[key]
        cs.log(f"{key}: {r['sites']:.0f} join sites, host {r['host_ms']:.3f} "
               f"ms, device {r['device_ms']:.4f} ms in {r['launches']:.0f} "
               f"launches; sorted_join calls {r['sorted_join_calls']:.0f}")
        top = list(r["kinds"].items())[:8]
        cs.log(f"  kinds: {top}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "kinds"}
                      if isinstance(v, dict) else v for k, v in res.items()
                      if k != "dcn_per_pass"}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"# join_sites: {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(rc)
