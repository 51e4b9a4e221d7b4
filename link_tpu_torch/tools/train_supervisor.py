"""Crash- and preemption-tolerant training launcher of the PyTorch port.

Counterpart of tools/train_supervisor.py: wraps a train CLI and relaunches
it from its latest checkpoint until the recipe completes
(`link_tpu_torch.train.supervisor`).

Usage:
  python3 -m link_tpu_torch.tools.train_supervisor --max-restarts 20 -- \
      python3 -m link_tpu_torch.tools.seg_train \
      configs/semantic_kitti/linkunet/default.yaml --run-dir runs/linkunet-a

The wrapped command must write checkpoints to a stable --run-dir;
`--resume auto` is appended to it (attempt 1 finds no checkpoint and starts
fresh). SIGTERM/SIGINT are forwarded to the child and stop the loop without
restarting.
"""

from __future__ import annotations

from ..train.supervisor import main

if __name__ == "__main__":
    raise SystemExit(main())
