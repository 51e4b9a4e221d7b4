"""Minimal name -> class registry (reference: det3d/utils/registry.py:6-44).

A copy of `link_tpu/utils/registry.py`, kept here so the port imports
nothing of the JAX package. The built-in builders (models/builder.py) cover
every reference component; the registry is the extension point: a custom
backbone, head or dataset is registered by name and built from a config
dict.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._modules: Dict[str, Any] = {}

    def register_module(self, cls=None, *, name: Optional[str] = None):
        def _register(c):
            self._modules[name or c.__name__] = c
            return c
        return _register(cls) if cls is not None else _register

    def get(self, key: str):
        return self._modules.get(key)

    def __contains__(self, key):
        return key in self._modules


def build_from_cfg(cfg: Dict, registry: Registry, default_args=None):
    """reference registry.py:21-44: pop 'type', look up, construct."""
    args = dict(cfg)
    obj_type = args.pop("type")
    cls = registry.get(obj_type)
    if cls is None:
        raise KeyError(f"{obj_type} not in {registry.name} registry")
    if default_args:
        for k, v in default_args.items():
            args.setdefault(k, v)
    return cls(**args)


READERS = Registry("reader")
BACKBONES = Registry("backbone")
NECKS = Registry("neck")
HEADS = Registry("head")
DETECTORS = Registry("detector")
DATASETS = Registry("dataset")
PIPELINES = Registry("pipeline")


def get_downsample_factor(model_config: Dict) -> int:
    """reference det3d/utils/config_tool.py:39: product of backbone ds
    factor and neck strides relative to upsampling."""
    try:
        neck = model_config["neck"]
        ds = 1
        for s in neck.get("ds_layer_strides", [1]):
            ds *= s
        us = neck.get("us_layer_strides", [1])
        if us:
            ds /= us[-1]
        backbone_ds = model_config.get("backbone", {}).get("ds_factor", 8)
        return int(backbone_ds * ds)
    except Exception:
        return 8
