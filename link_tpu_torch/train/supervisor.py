"""Failure-recovery supervisor: restart a training command from its last
checkpoint until it finishes.

A copy of `link_tpu/train/supervisor.py`, kept here so the port imports
nothing of the JAX package. The reference has no elastic recovery at all:
a crashed run is resumed by hand from epoch checkpoints (detection/tools/
train.py:77 `--resume_from`). This module wraps a train CLI
(`link_tpu_torch.tools.seg_train` / `det_train`, both of which checkpoint
every epoch and accept `--resume auto`) and relaunches it on crash or
preemption, so a long recipe survives worker failures without an operator.

Design notes:
- The child is a separate PROCESS, not a thread: a wedged CUDA context, a
  segfaulting native library or a device fault can only be recovered by
  process death (the reasoning of torch's elastic agent).
- `--resume auto` is appended to the child argv (unless the caller already
  passed a --resume), so attempt 1 starts fresh (no checkpoint in the run
  dir) and attempts 2+ continue from `latest.pt`.
- SIGTERM/SIGINT received by the supervisor are forwarded to the child and
  treated as a STOP request (no restart): a scheduler preempting the
  supervisor wants the job gone, not respawned. Crashes (any other nonzero
  exit) restart with exponential backoff.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["inject_resume", "supervise"]

# exit codes produced by signal death (POSIX: 128+signum shells, or
# negative returncode from subprocess) that mean "stop asked" when WE
# forwarded the signal.
_STOP_SIGNALS = (signal.SIGTERM, signal.SIGINT)


def inject_resume(cmd: Sequence[str], flag: str = "--resume") -> List[str]:
    """Append `--resume auto` to a train-CLI argv unless the caller
    already chose a resume behavior. Positional-safe: our train CLIs all
    accept `--resume [path|auto]` as an option, so appending is valid."""
    cmd = list(cmd)
    if flag not in cmd:
        cmd += [flag, "auto"]
    return cmd


def supervise(cmd: Sequence[str], max_restarts: int = 10,
              backoff: float = 5.0, backoff_cap: float = 300.0,
              resume: bool = True, env: Optional[Dict[str, str]] = None,
              log: Callable[[str], None] = lambda s: print(s, flush=True),
              _sleep: Callable[[float], None] = time.sleep) -> int:
    """Run `cmd` until it exits 0, restarting on crash.

    Returns the final exit code (0 on success; the child's last code if
    max_restarts is exhausted or a stop signal arrived). `max_restarts`
    counts RELAUNCHES, so the command runs at most max_restarts+1 times.
    Backoff doubles per consecutive crash, capped, and resets after the
    child survives >60 s (a long-lived run that crashes later is a new
    incident, not a crash loop).
    """
    run_cmd = inject_resume(cmd) if resume else list(cmd)
    child: Optional[subprocess.Popen] = None
    stop_requested = {"sig": None}

    def _forward(signum, frame):            # pragma: no cover - signal path
        stop_requested["sig"] = signum
        if child is not None and child.poll() is None:
            child.send_signal(signum)

    old_handlers = {s: signal.signal(s, _forward) for s in _STOP_SIGNALS}
    try:
        attempt = 0
        delay = backoff
        while True:
            t0 = time.monotonic()
            log(f"[supervisor] attempt {attempt + 1}: {' '.join(run_cmd)}")
            child = subprocess.Popen(run_cmd, env=env)
            code = child.wait()
            alive_s = time.monotonic() - t0
            if code == 0:
                log(f"[supervisor] finished ok after {attempt} restart(s)")
                return 0
            if stop_requested["sig"] is not None:
                log(f"[supervisor] stop requested "
                    f"(signal {stop_requested['sig']}), not restarting")
                return code
            if attempt >= max_restarts:
                log(f"[supervisor] giving up: exit {code} after "
                    f"{max_restarts} restart(s)")
                return code
            if alive_s > 60.0:
                delay = backoff             # healthy run, fresh incident
            log(f"[supervisor] child exited {code} after {alive_s:.1f}s; "
                f"restarting in {delay:.1f}s "
                f"({max_restarts - attempt} restart(s) left)")
            _sleep(delay)
            delay = min(delay * 2.0, backoff_cap)
            attempt += 1
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Restart a train CLI from its last checkpoint on "
                    "crash (pass the command after `--`).")
    ap.add_argument("--max-restarts", type=int, default=10)
    ap.add_argument("--backoff", type=float, default=5.0)
    ap.add_argument("--no-inject-resume", action="store_true",
                    help="do not append `--resume auto` to the command")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="command to supervise, e.g. "
                         "-- python3 -m link_tpu_torch.tools.seg_train cfg "
                         "--run-dir runs/x")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("no command given (pass it after `--`)")
    if "--resume" not in cmd and not args.no_inject_resume \
            and "--run-dir" not in cmd:
        ap.error("--resume auto needs a stable run dir: pass --run-dir "
                 "in the child command (or --no-inject-resume)")
    return supervise(cmd, max_restarts=args.max_restarts,
                     backoff=args.backoff,
                     resume=not args.no_inject_resume,
                     env=dict(os.environ))


if __name__ == "__main__":                   # pragma: no cover
    sys.exit(main())
