"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Loads, warms up, measures for --seconds, checks the timed path's output
against the plain reference, and prints one JSON object as the last line
of standard output (the compared numbers beside their limits also as the
last lines of standard error). With --trace 1 the metrics are the cell's
per-layer ones, read from a profiled run of a few steps after the window.
Exits non-zero, with no result, without a CUDA device (or fewer than the
cell's chips), or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()     # set-up counts from here: imports too

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device: str = "cuda", fault=None) -> int:
    """`device` "cpu" and `fault` (a callable that breaks the timed path,
    given the driver's state) serve the harness's own tests."""
    args = parse(argv)
    import torch
    c = harness.cell(args.workload)
    chips = int(c["entry"]["chips"])
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        harness.log(f"{args.workload} needs {chips} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    run = harness.Run(c, args.seed, args.seconds, bool(args.trace),
                      T_START if device == "cuda" else None)
    harness.driver(c).run(run, device=device, fault=fault)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"the run loaded forbidden modules: {bad}")
        return 4
    result = run.result(on_cpu=device == "cpu")
    for name, ch in result["checks"].items():
        print(f"check {name}: {ch['value']!r} (limit {ch['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
