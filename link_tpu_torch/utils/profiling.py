"""Profiling / observability utilities of the PyTorch port.

Counterpart of `link_tpu/utils/profiling.py`, rewritten for PyTorch (the
JAX module reads XLA's device trace and cost analysis). The reference has
only ad-hoc timing (SURVEY.md §5): IterTimerHook, dist_test middle-third
latency, a thop-based flops counter. Here:
  * `trace`: a torch.profiler run (CPU, and the card's CUDA activity when
    the work runs there) written as a Chrome trace;
  * `trace_device_ms_by_source`: the device ms of such a trace per
    `record_function` scope (the counterpart of XLA's `source` lanes; the
    port names its scopes in `sparse/coords.py`, `ops/elk.py`,
    `ops/point.py` and the trainers) and per kernel name;
  * `flops_of`: the floating-point operations of a call, PyTorch's
    operator count plus the hand kernels' products;
  * `IterTimer`: a step timer with a data / step split (a copy).
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Optional

import torch

NO_SCOPE = "(no scope)"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Capture a trace: `with trace('runs/prof', device): step(...)`.
    torch.profiler over the block, with CUDA activity when the card is
    there and `device` (default: the card when there is one) is a CUDA
    device; on leaving, the trace goes to <log_dir>/trace_<ns>.json
    (Chrome trace format, Perfetto reads it). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{time.time_ns()}.json"))


def _newest_trace(trace_dir: str) -> Optional[str]:
    files = [f for pat in ("*.json", "*.json.gz")
             for f in glob.glob(os.path.join(trace_dir, "**", pat),
                                recursive=True)]
    return max(files, key=os.path.getmtime) if files else None


def trace_device_ms_by_source(trace_dir: str) -> Dict[str, Dict]:
    """Read the newest trace under `trace_dir` (written by `trace`) and sum
    its device time: {"device": "cuda" or "cpu", "by_scope": {scope: ms},
    "by_kernel": {kernel: ms}, "launches": {kernel: count}, "total_ms"}.

    A device operation (kernel, copy, fill) belongs to the innermost
    `record_function` scope in which the runtime call that launched it
    started, on that call's thread (matched by CUPTI's correlation id, so
    that the hand kernels, launched through ctypes without an operator of
    their own, are counted), else to NO_SCOPE. A trace without device
    operations (a CPU run) reads the host instead: each scope's own time
    and each operator's time, nested ones included. Empty dicts when
    there is no trace."""
    path = _newest_trace(trace_dir)
    out = {"device": None, "by_scope": {}, "by_kernel": {}, "launches": {},
           "total_ms": 0.0}
    if path is None:
        return out
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    scopes = defaultdict(list)         # (pid, tid) -> [(start, end, name)]
    for e in events:
        if e.get("cat") == "user_annotation":
            scopes[(e["pid"], e["tid"])].append(
                (e["ts"], e["ts"] + e.get("dur", 0), e["name"]))

    def scope_at(pid, tid, ts):
        inner = None
        for a, b, name in scopes.get((pid, tid), ()):
            if a <= ts < b and (inner is None or a >= inner[0]):
                inner = (a, name)
        return inner[1] if inner else NO_SCOPE

    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    by_scope, by_kernel = defaultdict(float), defaultdict(float)
    launches = defaultdict(int)
    if device:
        launch_at = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch_at[corr] = (e["pid"], e["tid"], e["ts"])
        for e in device:
            ms = e.get("dur", 0) / 1e3
            where = launch_at.get(e.get("args", {}).get("correlation"))
            by_scope[scope_at(*where) if where else NO_SCOPE] += ms
            by_kernel[e["name"]] += ms
            launches[e["name"]] += 1
        out["device"] = "cuda"
    else:
        for name_scopes in scopes.values():
            for a, b, name in name_scopes:
                by_scope[name] += (b - a) / 1e3
        for e in events:
            if e.get("cat") == "cpu_op":
                by_kernel[e["name"]] += e.get("dur", 0) / 1e3
                launches[e["name"]] += 1
        out["device"] = "cpu"
    out.update(by_scope=dict(by_scope), by_kernel=dict(by_kernel),
               launches=dict(launches),
               total_ms=(sum(by_kernel.values()) if device
                         else sum(by_scope.values())))
    return out


# the hand kernels whose products PyTorch's counter cannot see, and the
# (K, M, Ci, Co) of a call from its arguments
_PRODUCTS = {
    # feats (N, Ci), idx (K, M), weight (K, Ci, Co)
    "gather_conv": lambda feats, idx, weight: (
        idx.shape[0], idx.shape[1], weight.shape[1], weight.shape[2]),
    # feats, base_pos, slot (K, M), groups, weight (K, Ci, Co)
    "window_conv": lambda feats, base_pos, slot, groups, weight: (
        slot.shape[0], slot.shape[1], weight.shape[1], weight.shape[2]),
    # feats (N, Ci), g (M, Co), bwd_idx (K, N)
    "gather_wgrad": lambda feats, g, bwd_idx, work=None: (
        bwd_idx.shape[0], bwd_idx.shape[1], feats.shape[1], g.shape[1]),
}


def flops_of(fn: Callable, *args, **kwargs) -> Optional[float]:
    """Floating-point operations of `fn(*args, **kwargs)` (replacement for
    det3d/utils/flops_counter.py): what `torch.utils.flop_counter.
    FlopCounterMode` counts of PyTorch's operators, plus the dense product
    count 2 K M Ci Co of every `gather_conv`, `window_conv` and
    `gather_wgrad` call, from its shapes (the hand kernels run through
    ctypes, out of the counter's sight; on the CPU their plain twins' own
    operators are taken out of the count in their place). M counts every
    row of the call, padding rows included, as XLA counts `_gm_impl`'s
    product in the JAX package. The number is not XLA's: it lacks the
    elementwise operations, which XLA's cost analysis adds. None when the
    call fails."""
    from torch.utils.flop_counter import FlopCounterMode
    from ..ops import kernels

    counter = FlopCounterMode(display=False)
    extra = [0]
    saved = {name: getattr(kernels, name) for name in _PRODUCTS}

    def counted(name, real):
        def call(*a, **kw):
            before = counter.get_total_flops()
            out = real(*a, **kw)
            k, m, ci, co = _PRODUCTS[name](*a, **kw)
            extra[0] += 2 * k * m * ci * co - (counter.get_total_flops()
                                               - before)
            return out
        return call

    try:
        for name, real in saved.items():
            setattr(kernels, name, counted(name, real))
        with counter:
            fn(*args, **kwargs)
        return float(counter.get_total_flops() + extra[0])
    except Exception:
        return None
    finally:
        for name, real in saved.items():
            setattr(kernels, name, real)


class IterTimer:
    """Running data/step time means, IterTimerHook-style."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.reset()

    def reset(self):
        self._n = 0
        self.data_time = 0.0
        self.step_time = 0.0
        self._t = time.perf_counter()

    def tic_data(self):
        self._t_data = time.perf_counter()

    def toc_data(self):
        self._dt_data = time.perf_counter() - self._t_data

    def toc_step(self):
        dt = time.perf_counter() - self._t
        self._n += 1
        if self._n > self.warmup:
            k = self._n - self.warmup
            self.data_time += (self._dt_data - self.data_time) / k
            self.step_time += (dt - self.step_time) / k
        self._t = time.perf_counter()

    def summary(self) -> Dict[str, float]:
        return {"data_time": self.data_time, "step_time": self.step_time}
