"""Config system: permissive attribute dicts + config.json reading.

The port's own copy of ``e4t_diffusion_tpu/config.py``: artifact
directories persist their run config verbatim as ``config.json``, tuned
artifacts nest the pretraining config under ``pretrained_args``, and
missing keys read as ``None``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Mapping, Optional


class AttributeDict:
    """Attribute access over a plain dict; missing attributes return None."""

    def __init__(self, obj: Optional[Mapping[str, Any]] = None):
        object.__setattr__(self, "obj", dict(obj or {}))

    def __getattr__(self, name: str) -> Any:
        obj = object.__getattribute__(self, "obj")
        if name in obj:
            return obj[name]
        return None

    def __setattr__(self, name: str, value: Any) -> None:
        if name == "obj":
            object.__setattr__(self, name, value)
        else:
            self.obj[name] = value

    def __getitem__(self, key: str) -> Any:
        return self.obj[key]

    def __contains__(self, key: str) -> bool:
        return key in self.obj

    def __repr__(self) -> str:
        return f"AttributeDict({self.obj!r})"

    def to_dict(self) -> dict:
        return dict(self.obj)


def save_config(config: Mapping[str, Any], save_dir: str) -> str:
    """Write ``config`` as ``config.json`` into ``save_dir`` (created if
    needed), in the JAX package's format (indent 2, str for the rest)."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "config.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(config, f, indent=2, default=str)
    return path


def load_config(path_or_dir: str) -> AttributeDict:
    """Load a config.json from a file path or an artifact directory."""
    path = path_or_dir
    if os.path.isdir(path):
        path = os.path.join(path, "config.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"No config.json at {path_or_dir}")
    with open(path, "r", encoding="utf-8") as f:
        return AttributeDict(json.load(f))


def get_e4t_config(config: AttributeDict) -> AttributeDict:
    """The E4T hyperparameter namespace: the nested ``pretrained_args``
    of a tuned artifact, else the config itself."""
    if config.pretrained_args is not None:
        return AttributeDict(config.pretrained_args)
    return config


def getattr_from_config(config: AttributeDict, key: str) -> Any:
    """Prefer the nested pretrained_args value; raise if absent otherwise."""
    if config.pretrained_args is not None:
        return config.pretrained_args[key]
    value = getattr(config, key)
    if value is None:
        raise KeyError(f"config key {key!r} is missing")
    return value
