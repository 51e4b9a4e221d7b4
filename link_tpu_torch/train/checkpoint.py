"""Checkpoint save/restore with rotation + best-metric tracking.

Counterpart of `link_tpu/train/checkpoint.py` with the same directory
protocol (`epoch_N` files, a `latest` symlink, a `best` hard link with
`best.json`, a JSON meta beside each file, rotation to `max_to_keep`). The
file is `torch.save` of the TrainState's {model, optimizer, step} as
`epoch_N.pt` where the JAX package writes msgpack.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

EXT = ".pt"


def _epoch_files(directory: str):
    return sorted(
        (p for p in os.listdir(directory)
         if p.startswith("epoch_") and p.endswith(EXT)),
        key=lambda p: int(p.split("_")[1].split(".")[0]))


def save_checkpoint(directory: str, state, epoch: int,
                    meta: Optional[Dict] = None, max_to_keep: int = 4,
                    metric: Optional[float] = None,
                    metric_name: str = "iou/val") -> str:
    """Write `state.state_dict()` as epoch_<epoch>.pt; returns its path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"epoch_{epoch}{EXT}")
    torch.save(state.state_dict(), path)
    meta = dict(meta or {})
    meta.update({"epoch": epoch})
    if metric is not None:
        meta[metric_name] = float(metric)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)

    latest = os.path.join(directory, "latest" + EXT)
    if os.path.islink(latest) or os.path.exists(latest):
        os.remove(latest)
    os.symlink(os.path.basename(path), latest)

    # Best-metric tracking (MaxSaver semantics).
    if metric is not None:
        best_meta_path = os.path.join(directory, "best.json")
        best = -float("inf")
        if os.path.exists(best_meta_path):
            with open(best_meta_path) as f:
                best = json.load(f).get(metric_name, -float("inf"))
        if metric > best:
            best_path = os.path.join(directory, "best" + EXT)
            if os.path.exists(best_path):
                os.remove(best_path)
            os.link(path, best_path)
            with open(best_meta_path, "w") as f:
                json.dump({metric_name: float(metric), "epoch": epoch}, f)

    # Rotate old epoch checkpoints.
    for old in _epoch_files(directory)[:-max_to_keep]:
        op = os.path.join(directory, old)
        os.remove(op)
        if os.path.exists(op + ".json"):
            os.remove(op + ".json")
    return path


def load_checkpoint(path: str, state):
    """Restore into a TrainState (follows the latest/best links); tensors
    land on the devices the state's model and optimizer already use."""
    state.load_state_dict(torch.load(path, map_location="cpu",
                                     weights_only=True))
    return state


def find_resume(directory: str) -> Optional[str]:
    """The newest checkpoint in a run dir, or None if it has none. Prefers
    the `latest` symlink; falls back to the highest epoch_N file if the
    symlink is missing or dangling."""
    latest = os.path.join(directory, "latest" + EXT)
    if os.path.exists(latest):          # follows the symlink
        return latest
    if not os.path.isdir(directory):
        return None
    cks = _epoch_files(directory)
    return os.path.join(directory, cks[-1]) if cks else None


def checkpoint_meta(path: str) -> Dict:
    mp = os.path.realpath(path) + ".json"   # latest.pt -> epoch_N.pt.json
    if os.path.exists(mp):
        with open(mp) as f:
            return json.load(f)
    return {}
