"""Profiling / observability utilities of the PyTorch port.

Counterpart of `link_tpu/utils/profiling.py`, rewritten for PyTorch (the
JAX module reads XLA's device trace and cost analysis). The reference has
only ad-hoc timing (SURVEY.md §5). Here:
  * `span`: a `record_function` range that exists only while a profiler
    runs, and `BackwardSpan`, the same range around a region's backward
    in the autograd graph; the range names of the port's layers;
  * `trace`: a torch.profiler run (CPU, and the card's CUDA activity when
    the work runs there) written as a Chrome trace;
  * `trace_device_ms_by_source`: the device ms of such a trace per
    `record_function` scope (the counterpart of XLA's `source` lanes) and
    per kernel name.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.profiler import record_function

# profiler ranges of the port's layers (the trainers, the join sites and
# the all-reduce name theirs beside their code)
CONV_FWD = "conv/fwd"          # the sparse conv kernels of a forward
CONV_DGRAD = "conv/dgrad"      # a sparse conv's feature gradient
CONV_WGRAD = "conv/wgrad"      # a sparse conv's weight gradient
PLAN = "sparse/plan"           # every kernel-map build (joins nest inside)
ELK_FWD = "elk/forward"        # the ELK block (its convs and plans nest)
ELK_BWD = "elk/backward"
LOSS_FWD = "loss/forward"      # the segmentation criterion
LOSS_BWD = "loss/backward"

_OFF = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a torch.profiler (or autograd profiler) run is recording."""
    return torch.autograd.profiler._is_profiler_enabled


def span(name: str):
    """`record_function(name)` while a profiler runs, else a shared no-op
    context: outside a profiler run the range costs no call into the
    profiler."""
    return record_function(name) if profiling() else _OFF


class BackwardSpan:
    """A range `name` around the backward of a region of the autograd
    graph, on the thread that runs it (autograd's, for the card):

        bwd = BackwardSpan(name, x)     # x: the region's input
        y = bwd.out(region(bwd.x))      # y: the region's output

    A hook before the node that made `y` opens the range; a hook before
    the node of `bwd.x`, a view of `x` that only the region reads, closes
    it. The autograd engine runs the ready node created last first, so the
    region's nodes run between the two, and a sibling branch (created
    earlier) after. The view adds no device operation. Marked only
    while a profiler runs and `x` needs a gradient (else nothing would
    close the range): otherwise `x` and `y` pass through and the graph
    gains no node."""

    def __init__(self, name: str, x: torch.Tensor):
        self.on = (profiling() and torch.is_grad_enabled()
                   and x.requires_grad)
        self._name, self._open = name, []
        if self.on:
            x = x.view_as(x)
            x.grad_fn.register_prehook(self._close_range)
        self.x = x

    def out(self, y: torch.Tensor) -> torch.Tensor:
        if self.on and y.grad_fn is not None:
            y.grad_fn.register_prehook(self._open_range)
        return y

    def _open_range(self, grad_outputs) -> None:
        self._open.append(
            torch.ops.profiler._record_function_enter_new(self._name, None))

    def _close_range(self, grad_outputs) -> None:
        if self._open:
            with torch._C.DisableTorchFunctionSubclass():
                torch.ops.profiler._record_function_exit._RecordFunction(
                    self._open.pop())


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
