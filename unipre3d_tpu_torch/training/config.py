"""Hydra-compatible YAML config composition (no Hydra dependency).

The port's own copy of unipre3d_tpu/training/config.py (it imports
nothing of the JAX package); it reads the YAMLs under
``unipre3d_tpu_torch/configs/``.

Supports the subset of Hydra 1.3 semantics the reference configs use
(reference configs/default_config.yaml, configs/settings.yaml,
configs/<backbone>_pretraining.yaml):

* ``defaults:`` lists with absolute entries (``/settings@_here_``,
  ``/dataset/shapenet@_here_``), group entries (``wandb: defaults`` loads
  ``wandb/defaults.yaml`` under key ``wandb``), and ``_self_`` ordering.
* ``# @package _global_`` header promoting a group file to the root.
* CLI usage ``--config-name <name>`` plus dotlist overrides ``a.b=c``.

Configs compose by deep merge; later sources win. ``_self_`` (the file's own
body) is merged last unless explicitly positioned.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Iterable

import yaml


class ConfigNode(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigNode({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @staticmethod
    def from_obj(obj: Any) -> Any:
        if isinstance(obj, dict):
            return ConfigNode({k: ConfigNode.from_obj(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ConfigNode.from_obj(v) for v in obj]
        return obj

    def to_plain(self) -> Any:
        def conv(o):
            if isinstance(o, dict):
                return {k: conv(v) for k, v in o.items()}
            if isinstance(o, list):
                return [conv(v) for v in o]
            return o
        return conv(self)


def _deep_merge(base: dict, extra: dict) -> dict:
    """Merge ``extra`` into ``base`` (extra wins); returns base."""
    for k, v in extra.items():
        if k in base and isinstance(base[k], dict) and isinstance(v, dict):
            _deep_merge(base[k], v)
        else:
            base[k] = copy.deepcopy(v)
    return base


def _is_global_package(path: str) -> bool:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                if "@package" in line and "_global_" in line:
                    return True
                continue
            break
    return False


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        data = yaml.safe_load(f)
    return data or {}


def _compose_file(config_dir: str, rel_name: str, _stack: tuple = ()) -> dict:
    """Compose one config file (recursively resolving its defaults list)."""
    rel_name = rel_name.lstrip("/")
    path = os.path.join(config_dir, rel_name + ".yaml")
    if not os.path.exists(path):
        raise FileNotFoundError(f"config not found: {path}")
    if rel_name in _stack:
        raise ValueError(f"circular config defaults: {_stack + (rel_name,)}")
    _stack = _stack + (rel_name,)

    body = _load_yaml(path)
    defaults = body.pop("defaults", [])
    group_dir = os.path.dirname(rel_name)

    merged: dict = {}
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            _deep_merge(merged, body)
            self_merged = True
            continue
        if isinstance(entry, str):
            # absolute or sibling reference; strip Hydra package annotation
            name = entry.split("@")[0]
            if not name.startswith("/") and group_dir:
                name = os.path.join(group_dir, name)
            sub = _compose_file(config_dir, name, _stack)
            _deep_merge(merged, sub)
        elif isinstance(entry, dict):
            # group: option  ->  load <group>/<option>.yaml under key <group>
            for group, option in entry.items():
                if option is None:
                    continue
                group_rel = os.path.join(group_dir, group) if group_dir else group
                sub_path = os.path.join(config_dir, group_rel, str(option) + ".yaml")
                sub = _compose_file(config_dir, os.path.join(group_rel, str(option)),
                                    _stack)
                if _is_global_package(sub_path):
                    _deep_merge(merged, sub)
                else:
                    _deep_merge(merged, {group: sub})
        else:
            raise ValueError(f"unsupported defaults entry: {entry!r}")
    if not self_merged:
        _deep_merge(merged, body)
    return merged


def _parse_override_value(v: str) -> Any:
    try:
        return yaml.safe_load(v)
    except yaml.YAMLError:
        return v


def apply_overrides(cfg: dict, overrides: Iterable[str]) -> dict:
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov!r}")
        key, _, value = ov.partition("=")
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, ConfigNode())
        node[parts[-1]] = ConfigNode.from_obj(_parse_override_value(value))
    return cfg


def load_config(config_name: str, config_dir: str | None = None,
                overrides: Iterable[str] = ()) -> ConfigNode:
    """Compose a config by name (e.g. ``transformer_pretraining``)."""
    if config_dir is None:
        config_dir = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                  "configs")
    merged = _compose_file(config_dir, config_name)
    cfg = ConfigNode.from_obj(merged)
    apply_overrides(cfg, overrides)
    return cfg


def save_config(cfg: ConfigNode, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_plain(), f, sort_keys=False)
