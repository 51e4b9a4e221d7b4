"""Structured training logs: JSONL metrics + running means, and tensorboard
scalars. A copy of `link_tpu/utils/logging.py`, kept here so the port
imports nothing of the JAX package; its TensorboardLogger writes through
`torch.utils.tensorboard` where the JAX package's writes through flax.

Replaces torchie's LogBuffer + TextLoggerHook (reference:
det3d/torchie/trainer/log_buffer.py, hooks/logger/text.py) and the seg
stack's tensorboard scalars (trainers.py:44,76) with an append-only
metrics.jsonl any dashboard can tail.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class LogBuffer:
    """Running means between flushes (torchie LogBuffer semantics)."""

    def __init__(self):
        self._sum = defaultdict(float)
        self._cnt = defaultdict(int)

    def update(self, metrics: Dict[str, float]):
        for k, v in metrics.items():
            self._sum[k] += float(v)
            self._cnt[k] += 1

    def average(self) -> Dict[str, float]:
        return {k: self._sum[k] / max(self._cnt[k], 1) for k in self._sum}

    def clear(self):
        self._sum.clear()
        self._cnt.clear()


class MetricsLogger:
    def __init__(self, run_dir: str, filename: str = "metrics.jsonl",
                 interval: int = 5):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, filename)
        self.interval = interval
        self.buffer = LogBuffer()
        self._step = 0

    def log_step(self, metrics: Dict[str, float], step: Optional[int] = None,
                 **extra):
        self._step = step if step is not None else self._step + 1
        self.buffer.update(metrics)
        if self._step % self.interval == 0:
            rec = {"step": self._step, "time": time.time(),
                   **self.buffer.average(), **extra}
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            self.buffer.clear()

    def log(self, record: Dict):
        with open(self.path, "a") as f:
            f.write(json.dumps({"time": time.time(), **record}) + "\n")


class TensorboardLogger:
    """Tensorboard scalar events (reference: segmentation trainers.py:44,76
    summary writer + detection TensorboardLoggerHook,
    torchie/trainer/hooks/logger/tensorboard.py). Writes real event files
    under <run_dir>/tensorboard through `torch.utils.tensorboard` when the
    `tensorboard` package imports, and is a no-op otherwise (the JSONL log
    stays authoritative)."""

    def __init__(self, run_dir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._writer = SummaryWriter(os.path.join(run_dir, "tensorboard"))
        except Exception:
            pass

    @property
    def active(self) -> bool:
        return self._writer is not None

    def scalars(self, metrics: Dict[str, float], step: int):
        if self._writer is None:
            return
        for k, v in metrics.items():
            try:
                self._writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass

    def flush(self):
        if self._writer is not None:
            self._writer.flush()


def save_runtime_code(run_dir: str, repo_root: Optional[str] = None):
    """Snapshot the source tree into <run_dir>/backup so old checkpoints
    stay runnable (reference saveRuntimeCode, segmentation/train.py:59-62 +
    detection/tools/train.py:129-138 rsync backup)."""
    import shutil

    repo_root = repo_root or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    dst = os.path.join(run_dir, "backup")
    os.makedirs(dst, exist_ok=True)
    for top in ("link_tpu_torch", "configs", "chip_smoke.py"):
        src = os.path.join(repo_root, top)
        if not os.path.exists(src):
            continue
        out = os.path.join(dst, top)
        if os.path.isdir(src):
            shutil.copytree(
                src, out, dirs_exist_ok=True,
                ignore=shutil.ignore_patterns("__pycache__", "*.pyc",
                                              "*.so", "_build"))
        else:
            shutil.copy2(src, out)
    return dst
