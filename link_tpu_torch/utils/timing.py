"""Device-side timing of a callable on the card.

Back-to-back launches through a Python wrapper arrive at the host's launch
interval (~15-25 us through ctypes on the H100 machines, and more when the
host stalls), so CUDA events around a loop of calls measure the host, not
the card, for any call near that. `device_ms` captures the calls into a
CUDA graph and times its replay, which launches them from the device
without the host in between.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def events_ms(run: Callable[[], object], div: int = 1, reps: int = 1) -> float:
    """Least of `reps` CUDA-event timings of `run()`, divided by `div`: the
    host's pace and the card's together."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / div)
    return best


def _loop(fn: Callable[[], object], iters: int) -> Callable[[], None]:
    def run():
        for _ in range(iters):
            fn()
    return run


def graph_ms(fn: Callable[[], object], iters: int, reps: int = 1) -> float:
    """Device ms per call of `fn` from the replay of a CUDA graph holding
    `iters` calls (least of `reps` replays). Raises what the capture
    raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                        # warm on the capture's stream first
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    ms = events_ms(graph.replay, iters, reps)
    del graph
    return ms


def device_ms(fn: Callable[[], object], iters: int,
              reps: int = 1) -> Tuple[float, str]:
    """Device ms per call of `fn` on the current card by `graph_ms`, and how
    it was timed: "graph", or "events; graph capture failed: <error>" when
    the capture raised, in which case the time is that of CUDA events
    around `iters` back-to-back calls (least of `reps`), paced by the host;
    the caller reports it."""
    try:
        return graph_ms(fn, iters, reps), "graph"
    except Exception as exc:     # reported, not hidden: the caller logs it
        torch.cuda.synchronize()
        fn()
        return (events_ms(_loop(fn, iters), iters, reps),
                f"events; graph capture failed: {type(exc).__name__}: {exc}")
