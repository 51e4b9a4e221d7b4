"""The readings behind a cell's correctness limits: for each seed, the
program's timed path against the plain reference, the lower-precision
control against the reference, and the cell's planted faults, as the
cell's driver defines them (`calibrate(run, device)`), each judged as a
run judges its numbers: `correct` beside each reading, by `Run.check`
against the limits of the cell's configuration. Not part of a benchmark
run.

    python3 perfbench/calibrate.py --workload <name> --seeds 1 2 3 \
        [--out chiprun_out/calibrate.jsonl]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402


def judge(c, out: dict) -> dict:
    """Adds `correct` to each reading of `out` that holds numbers the
    configuration limits: the harness's own check of those numbers (a
    sound run has to pass them all; a control or a fault fails by one)."""
    lim = c["config"]["limits"]
    for reading in out.values():
        if isinstance(reading, dict) and any(k in reading for k in lim):
            run = harness.Run(c, out["seed"], 0.0, False)
            for k in lim:
                if k in reading:
                    run.check(k, reading[k], lim[k])
            reading["correct"] = run.correct
    return out


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = harness.cell(args.workload)
    drv = harness.driver(c)
    for seed in args.seeds:
        run = harness.Run(c, seed, 0.0, False)
        out = judge(c, drv.calibrate(run, device=device))
        line = json.dumps(out)
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
