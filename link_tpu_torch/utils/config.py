"""Unified config system. A copy of `link_tpu/utils/config.py`, kept here
so the port imports nothing of the JAX package.

The reference uses two systems: torchpack's recursive-include YAML cascade
(segmentation/train.py:38: every `default.yaml` from the filesystem root of
the config tree down to the file's directory is merged, then the file, then
CLI dot-overrides) and mmcv-style executable Python config files
(detection/det3d/torchie/utils/config.py:51-162). This module provides one
attr-dict `Config` with both loaders.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Any, Dict, List, Optional

import yaml


class Config(dict):
    """Dict with attribute access, nested-dict wrapping, and deep merge."""

    def __init__(self, d: Optional[Dict] = None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = v

    def __setitem__(self, k, v):
        if isinstance(v, dict) and not isinstance(v, Config):
            v = Config(v)
        super().__setitem__(k, v)

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def merge(self, other: Dict) -> "Config":
        for k, v in other.items():
            if (k in self and isinstance(self[k], Config)
                    and isinstance(v, dict)):
                self[k].merge(v)
            else:
                self[k] = v
        return self

    def set_dotted(self, key: str, value: Any):
        parts = key.split(".")
        node = self
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], Config):
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = _parse_value(value)

    def to_dict(self) -> Dict:
        return {k: (v.to_dict() if isinstance(v, Config) else v)
                for k, v in self.items()}


def _parse_value(v: str) -> Any:
    if not isinstance(v, str):
        return v
    try:
        return yaml.safe_load(v)
    except yaml.YAMLError:
        return v


def load_yaml_cascade(path: str, overrides: Optional[List[str]] = None,
                      root: Optional[str] = None) -> Config:
    """torchpack `configs.load(path, recursive=True)` semantics: merge every
    default.yaml on the directory chain (outermost first), then the target
    file, then `key=value` dot-overrides."""
    path = os.path.abspath(path)
    chain: List[str] = []
    d = os.path.dirname(path)
    stop = os.path.abspath(root) if root else None
    while True:
        default = os.path.join(d, "default.yaml")
        if os.path.exists(default) and default != path:
            chain.append(default)
        if (stop and d == stop) or os.path.dirname(d) == d:
            break
        parent = os.path.dirname(d)
        if stop is None and not any(
                os.path.exists(os.path.join(parent, n))
                for n in ("default.yaml",)) and not chain:
            pass
        if parent == d:
            break
        d = parent
        if stop is None and len(chain) > 8:
            break
    cfg = Config()
    for f in reversed(chain):
        with open(f) as fh:
            cfg.merge(yaml.safe_load(fh) or {})
    with open(path) as fh:
        cfg.merge(yaml.safe_load(fh) or {})
    for ov in overrides or []:
        if "=" in ov:
            k, v = ov.split("=", 1)
            cfg.set_dotted(k.lstrip("-"), v)
    return cfg


def load_py_config(path: str) -> Config:
    """mmcv-style executable python config (torchie utils/config.py:78-103):
    module-level names become config entries; `cfg.text` carries the source
    snapshot for checkpoint meta."""
    spec = importlib.util.spec_from_file_location("_link_cfg", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = Config({k: v for k, v in vars(mod).items()
                  if not k.startswith("__") and not callable(v)
                  and not isinstance(v, type(importlib))})
    with open(path) as f:
        cfg["text"] = f.read()
    return cfg


def load_config(path: str, overrides: Optional[List[str]] = None) -> Config:
    if path.endswith((".yml", ".yaml")):
        return load_yaml_cascade(path, overrides)
    if path.endswith(".py"):
        cfg = load_py_config(path)
        for ov in overrides or []:
            if "=" in ov:
                k, v = ov.split("=", 1)
                cfg.set_dotted(k.lstrip("-"), v)
        return cfg
    raise ValueError(f"unsupported config format: {path}")
