"""Device time launched inside the port's layer spans, by a sorted bisect.

`trace.seconds_in` tests every operation against every range, which at
~23k operations and ~500 conv spans a trace is slow. Here the spans of the
names asked for are merged into disjoint intervals (nested and overlapping
spans, on any thread, count once) and each operation's launch time is
looked up by bisection.

The span names are the port's (`link_tpu_torch/utils/profiling.py`); a
trace of a program without them has none, and the readers then read
nothing.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, Iterable, List, Optional, Tuple

CONV_FWD = "conv/fwd"
CONV_DGRAD = "conv/dgrad"
CONV_WGRAD = "conv/wgrad"
CONV = (CONV_FWD, CONV_DGRAD, CONV_WGRAD)
PLAN = "sparse/plan"
ELK = ("elk/forward", "elk/backward")
LOSS = ("loss/forward", "loss/backward")


def merged(red: Dict, names: Iterable[str]) -> List[Tuple[int, int]]:
    """The union of the spans named in `names` as sorted, disjoint
    (start, end) intervals."""
    names = set(names)
    spans = sorted((a, b) for a, b, n in red["ranges"] if n in names)
    out: List[List[int]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def seconds_in(red: Dict, names: Iterable[str]) -> Optional[float]:
    """Device seconds of the operations launched inside any span named in
    `names`, or None when the trace holds no such span."""
    spans = merged(red, names)
    if not spans:
        return None
    starts = [a for a, _ in spans]
    total = 0.0
    for ts, s, _ in red["ops"]:
        if ts is None:
            continue
        i = bisect_right(starts, ts) - 1
        if i >= 0 and ts < spans[i][1]:
            total += s
    return total


def ms_per_sample(run, names: Iterable[str]) -> Optional[float]:
    """`seconds_in` as ms a sample of the traced steps."""
    if run.red is None:
        return None
    s = seconds_in(run.red, names)
    if s is None:
        return None
    return s * 1e3 / run.info["samples_traced"]
