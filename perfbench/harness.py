"""The parts of a benchmark run that every cell shares.

A cell is found by name: its entry in BENCHMARK.json names a configuration
(a JSON file of sizes, under `configs/`) and a traffic mix (a JSON file of
parameters, `traffic/<name>.json`); the traffic names the driver
(`drivers/<driver>.py`) that runs it. The cell's end-to-end metrics are
those of BENCHMARK.json that list it (or list no cells); its per-layer
metrics likewise, each read by `metrics/<name>.py`. A later change adds a
configuration, a traffic mix, a driver or a metric as files of their own
plus entries in BENCHMARK.json, and edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "link_tpu")


def log(msg: str) -> None:
    print(f"[perfbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"no BENCHMARK.json beside {BENCH_DIR.name}/")
    return load_json(path)


def cell(name: str, bench: Optional[Dict] = None) -> Dict:
    """The cell's entry, configuration, traffic and metrics."""
    bench = bench or benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")

    def applies(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if applies(m)
             and m["moves"] in e2e_names]
    return {"name": name, "entry": w, "config": cfg, "traffic": traffic,
            "end_to_end": e2e, "per_layer": layer,
            "run_seconds": bench["run_seconds"]}


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(c: Dict):
    return load_module(BENCH_DIR / "drivers" / f"{c['traffic']['driver']}.py",
                       f"perfbench_driver_{c['traffic']['driver']}")


def metric_reader(name: str):
    """`metrics/<name>.py`, or else the reader of the quantity that the
    name splits by the end-to-end metric it moves: `input.h2d_ms.train`
    falls back to `metrics/input.h2d_ms.py`."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = BENCH_DIR / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    return load_module(path, "perfbench_metric_" + path.stem.replace(".", "_"))


def draw_weights(spec, seed: int, dev):
    """Every parameter of `spec` ((name, shape, init) rows) from one uniform
    draw on the device: U(-init, init), or the constant -init where init
    is not positive (its span of the draw left unused)."""
    import numpy as np
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % 2**63)
    total = sum(int(np.prod(shape)) for _, shape, _ in spec)
    u = torch.rand(total, generator=gen, device=dev) * 2 - 1
    out, at = {}, 0
    for name, shape, init in spec:
        n = int(np.prod(shape))
        out[name] = (u[at:at + n].view(shape) * init if init > 0
                     else torch.full(shape, -init, device=dev))
        at += n
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is, as a
    whole, one of FORBIDDEN: `link_tpu_torch` is not `link_tpu`."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def p95(values: List[float]) -> float:
    """The 95th percentile (linear interpolation between order
    statistics)."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    pos = 0.95 * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Run:
    """What a run gathers: timings, counts, the reduced trace, the
    correctness readings; `result()` forms the result line."""

    def __init__(self, c: Dict, seed: int, seconds: float, trace: bool,
                 t_start: Optional[float] = None):
        """`t_start`: the process's start on the `perf_counter` clock, from
        which set-up counts (imports included); by default now."""
        self.cell = c
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.setup_s = None
        self.window: Dict = {}
        self.red: Optional[Dict] = None
        self.info: Dict = {}
        self.checks: List[Dict] = []
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0

    def mark(self, what: str) -> None:
        """Logs a step of set-up with the seconds since the start."""
        log(f"{what}: {time.perf_counter() - self.t_start:.2f} s from the "
            "start")

    def check(self, name: str, value: float, limit: float) -> None:
        """One compared number beside its limit, which it may not pass."""
        ok = value <= limit                   # NaN fails
        self.checks.append({"name": name, "value": value, "limit": limit,
                            "ok": bool(ok)})

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c["ok"] for c in self.checks)

    def metrics(self) -> Dict:
        out = {}
        if not self.trace:
            for m in self.cell["end_to_end"]:
                v = self.window.get(m["name"])
                if m["name"] == "setup_s":
                    v = self.setup_s
                if v is not None:
                    out[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            for m in self.cell["per_layer"]:
                v = metric_reader(m["name"]).read(self)
                if v is not None:
                    out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out

    def result(self, on_cpu: bool = False) -> Dict:
        import torch
        device = {"platform": "cpu" if on_cpu else "gpu",
                  "kind": "cpu" if on_cpu else torch.cuda.get_device_name(0),
                  "count": int(self.cell["entry"]["chips"]),
                  "memory_peak_bytes": int(self.memory_peak)}
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": self.metrics(),
               "device": device}
        if self.trace and self.red is not None:
            device["busy_s"] = self.red["busy_s"]
            device["window_s"] = self.red["window_s"]
            from .trace import top_ops
            out["breakdown"] = {"device_ops": top_ops(self.red),
                                "idle_gaps": self.red["idle_gaps"]}
        out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                         for c in self.checks}
        return out

