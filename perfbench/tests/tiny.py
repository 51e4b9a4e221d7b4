"""A temporary checkout of the benchmark with tiny cells, for the harness's
tests on the CPU: the benchmark's files, BENCHMARK.json with the tiny
cells added as new entries, tiny configurations and traffic added as new
files. The port is imported from the repository beside it."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_SEG_CFG = {"capacities_per_scan": [1024, 768, 512, 384, 256], "cr": 0.125}
TINY_SEG_TRAFFIC = {
    "pool_batches": 5, "points_per_scan": 900, "voxel_size_m": 0.4,
    "sensor": {"beams": 8, "azimuths": 192, "max_range_m": 30.0},
    "scene": {"scene_reach_m": 35.0}}


DTYPE = "bfloat16"
TINY_DET_CFG = {
    "voxel_size": [0.6, 0.6, 0.2], "pc_range": [-52.8, -52.8, -5.0, 52.8, 52.8, 3.0],
    "grid": [176, 176, 40], "max_voxels": 6000, "dtype": DTYPE,
    "capacities_per_frame": [8192, 4096, 2048, 1024],
    "test_cfg": {"pc_range": [-52.8, -52.8], "voxel_size": [0.6, 0.6]}}
TINY_DET_TRAFFIC = {
    "pool_frames": 4, "sweeps": 3,
    "sensor": {"beams": 8, "azimuths": 160, "max_range_m": 40.0},
    "scene": {"scene_reach_m": 45.0}}


# the inference driver's metrics: its cell is not in BENCHMARK.json yet
DET_END_TO_END = [
    {"name": "infer_samples_per_s", "unit": "samples/s", "better": "higher",
     "bound": 0.25, "source": "host_clock"},
    {"name": "latency_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
     "source": "host_clock"}]
DET_PER_LAYER = [
    ("input.h2d_ms.infer", "ms/sample", "lower", "input"),
    ("join.device_ms.infer", "ms/sample", "lower", "join sites"),
    ("conv_roofline.infer", "%", "higher", "kernels"),
    ("step_mfu.infer", "%", "higher", "model step"),
    ("device.idle_pct.infer", "%", "lower", "device"),
    ("device.launches_per_sample.infer", "launches/sample", "lower",
     "device")]


def _merged(base, over):
    out = dict(base)
    for k, v in over.items():
        out[k] = _merged(base[k], v) if isinstance(v, dict) and k in base \
            else v
    return out


def make_checkout(tmp: Path, seconds_bound: float = 0.25) -> Path:
    """tmp/checkout: perfbench/ copied, tiny cells added."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "perfbench/configs/linkunet_semkitti.json")
                     .read_text())
    (root / "perfbench/configs/tiny_linkunet.json").write_text(
        json.dumps(_merged(cfg, TINY_SEG_CFG)))
    tr = json.loads((REPO / "perfbench/traffic/semkitti_train.json")
                    .read_text())
    (root / "perfbench/traffic/tiny_semkitti.json").write_text(
        json.dumps(_merged(tr, TINY_SEG_TRAFFIC)))
    dcfg = json.loads((REPO / "perfbench/configs/centerpoint_elkv3_nusc.json")
                      .read_text())
    (root / "perfbench/configs/tiny_centerpoint.json").write_text(
        json.dumps(_merged(dcfg, TINY_DET_CFG)))
    dtr = json.loads((REPO / "perfbench/traffic/nusc_dflip.json").read_text())
    (root / "perfbench/traffic/tiny_nusc.json").write_text(
        json.dumps(_merged(dtr, TINY_DET_TRAFFIC)))
    bench["configs"].append({"name": "tiny_centerpoint", "source": "test",
                             "file": "perfbench/configs/tiny_centerpoint.json",
                             "reduced": ["grid"], "why": "test"})
    bench["workloads"].append({"name": "tiny.det", "config": "tiny_centerpoint",
                               "traffic": "tiny_nusc", "chips": 1,
                               "why": "test"})
    bench["configs"].append({"name": "tiny_linkunet", "source": "test",
                             "file": "perfbench/configs/tiny_linkunet.json",
                             "reduced": ["cr"], "why": "test"})
    bench["workloads"].append({"name": "tiny.seg", "config": "tiny_linkunet",
                               "traffic": "tiny_semkitti", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "seg_train.linkunet.b2" in m.get("workloads", []):
            m["workloads"].append("tiny.seg")
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    bench["end_to_end"] += [dict(m, workloads=["tiny.det"])
                            for m in DET_END_TO_END if m["name"] not in names]
    bench["per_layer"] += [
        {"name": n, "unit": u, "better": b, "source": "device_trace",
         "layer": layer, "moves": "infer_samples_per_s",
         "workloads": ["tiny.det"]}
        for n, u, b, layer in DET_PER_LAYER if n not in names]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _use_checkout(root: Path) -> None:
    """Import `perfbench` from the checkout at `root` from now on, the port
    from the repository."""
    for p in (str(root), str(REPO)):
        if p not in sys.path:
            sys.path.insert(0, p)
    for name in [m for m in sys.modules if m == "perfbench"
                 or m.startswith("perfbench.")]:
        del sys.modules[name]
    sys.path.remove(str(root))
    sys.path.insert(0, str(root))


def run_main(root: Path, argv, **kw):
    """perfbench/run.py's main in the checkout at `root`."""
    _use_checkout(root)
    from perfbench import run as runmod
    return runmod.main(argv, **kw)


def calibrate(root: Path, workload: str, seed: int):
    """The cell's configuration and its driver's calibration readings on
    one seed, each judged by the harness against the cell's limits, on the
    CPU, in the checkout at `root`."""
    _use_checkout(root)
    from perfbench import calibrate as cal
    from perfbench import harness
    c = harness.cell(workload)
    return c, cal.judge(c, harness.driver(c).calibrate(
        harness.Run(c, seed, 0.0, False), device="cpu"))


def det_geometry():
    """Patch the port's det_test runner to the tiny cell's grid, capacity
    and test config (its module constants; the tools' CPU tests patch them
    alike). Returns a function that restores them."""
    from link_tpu_torch.tools import det_test
    saved = (det_test.GRID, det_test.CAPACITY, dict(det_test.TEST_CFG))
    det_test.GRID = tuple(TINY_DET_CFG["grid"])
    det_test.CAPACITY = TINY_DET_CFG["capacities_per_frame"][0]
    det_test.TEST_CFG.update(TINY_DET_CFG["test_cfg"])

    def restore():
        det_test.GRID, det_test.CAPACITY = saved[:2]
        det_test.TEST_CFG.clear()
        det_test.TEST_CFG.update(saved[2])
    return restore
