"""A profiled run of a few steps and its reduction to per-layer numbers.

`traced(run)` runs `run()` under torch.profiler (host and card) as the
active step of a schedule whose warm-up step makes tiny launches, which the
profiler discards: a long process's trace was seen to lose the card's first
kernel records, and such a warm-up step takes them. `reduce(prof)` reads
the active step from the profiler's own events (no trace file): each
device operation with its time and the time of the runtime call that
launched it (by CUPTI's correlation id), the host ranges, the union of
the device's busy intervals, the window (the profiler step's host range),
and the longest idle gaps labelled by the host range open at their
start. `seconds_in` gives the device time launched inside named ranges.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch

WARM_LAUNCHES, WARM_S = 256, 0.02
MAX_RETAKES = 2


def traced(run: Callable[[], None]):
    from torch.profiler import ProfilerActivity, profile, schedule
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        n, t_end = 0, time.perf_counter() + WARM_S
        while n < WARM_LAUNCHES or time.perf_counter() < t_end:
            x.add_(1)
            n += 1
        torch.cuda.synchronize()
        prof.step()
        run()
        torch.cuda.synchronize()
        prof.step()
    return prof


def _is_range(name: str) -> bool:
    return "/" in name and not name.startswith(("aten::", "cuda", "cu",
                                                "ProfilerStep"))


def reduce(prof) -> Dict:
    """Device time by operation name, copies from host to device,
    launches, busy seconds, the window and its idle gaps."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    # the profiler mirrors each host range on the device's timeline as an
    # annotation spanning its work: not an operation
    marks = {e.name() for e in cpu if _is_range(e.name())
             or e.name().startswith("ProfilerStep")}
    dev = [e for e in events if e.device_type() != DeviceType.CPU
           and e.name() not in marks]
    steps = [e for e in cpu if e.name().startswith("ProfilerStep")]
    if steps:
        w0 = min(e.start_ns() for e in steps)
        w1 = max(e.end_ns() for e in steps)
    else:
        w0 = min(e.start_ns() for e in events)
        w1 = max(e.end_ns() for e in events)
    runtime = {e.correlation_id(): e for e in cpu
               if e.name().startswith("cu") and e.correlation_id()}
    ranges = [(e.start_ns(), e.end_ns(), e.name()) for e in cpu
              if _is_range(e.name())]

    by_name = defaultdict(float)
    launches = defaultdict(int)
    h2d = 0.0
    intervals, ops = [], []
    for e in dev:
        a, b = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if b <= a:
            continue
        s = (b - a) / 1e9
        name = e.name()
        by_name[name] += s
        launches[name] += 1
        if "HtoD" in name:
            h2d += s
        r = runtime.get(e.correlation_id())
        intervals.append((a, b))
        ops.append((r.start_ns() if r else None, s, name))
    intervals.sort()
    busy, gaps = 0, []
    cur_a = cur_b = None
    last_end = w0
    for a, b in intervals:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            if a > last_end:
                gaps.append((last_end, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
        last_end = max(last_end, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    if w1 > last_end:
        gaps.append((last_end, w1))
    main = steps[0].start_thread_id() if steps else None
    gaps.sort(key=lambda g: g[0] - g[1])
    idle_gaps = [[_host_doing(cpu, g[0], main), (g[1] - g[0]) / 1e9]
                 for g in gaps[:10]]
    records = {"sorted_join_kernel": sum(1 for e in dev
                                         if "sorted_join_kernel" in e.name())}
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9,
            "device_s": sum(by_name.values()), "by_name": dict(by_name),
            "launches": dict(launches),
            "n_launches": sum(launches.values()), "h2d_s": h2d,
            "records": records, "idle_gaps": idle_gaps, "ops": ops,
            "ranges": ranges}


def seconds_in(red: Dict, names) -> float:
    """Device seconds of the operations launched inside any host range
    named in `names` (on any thread: the backward's launches come from the
    autograd engine's thread while the main thread waits in its range)."""
    spans = [(a, b) for a, b, n in red["ranges"] if n in names]
    return sum(s for ts, s, _ in red["ops"]
               if ts is not None and any(a <= ts < b for a, b in spans))


def seconds_of(red: Dict, fragments) -> float:
    """Device seconds of the operations whose name holds any of
    `fragments`."""
    return sum(v for k, v in red["by_name"].items()
               if any(f in k for f in fragments))


def _host_doing(cpu, ts: int, thread) -> str:
    """The innermost host range or operator open at `ts` on `thread`."""
    best, best_start = "host", -1
    for e in cpu:
        if e.start_thread_id() != thread or e.name().startswith(
                "ProfilerStep"):
            continue
        if e.start_ns() <= ts < e.end_ns() and e.start_ns() > best_start:
            best, best_start = e.name(), e.start_ns()
    return best


def top_ops(red: Dict, n: int = 10) -> List:
    return [[k, v] for k, v in sorted(red["by_name"].items(),
                                      key=lambda kv: -kv[1])[:n]]


def traced_complete(run: Callable[[], None], joins_launched: Callable[[], int],
                    log) -> Dict:
    """`run` traced and reduced; retaken (at most MAX_RETAKES times) while
    the trace lacks a `sorted_join` kernel record that the wrapper counted
    (`joins_launched()` gives the count of the last run)."""
    for attempt in range(MAX_RETAKES + 1):
        red = reduce(traced(run))
        want = joins_launched()
        got = red["records"]["sorted_join_kernel"]
        red["retakes"] = attempt
        if got == want:
            return red
        log(f"trace holds {got} of {want} sorted_join records; "
            f"{'retaking' if attempt < MAX_RETAKES else 'kept as it is'}")
    red["incomplete"] = True
    return red
