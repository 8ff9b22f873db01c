"""Config files: YAML -> an attribute dict.

The port's own copy of ``lt_tpu/utils/cfg.py`` (``lt_tpu`` imports JAX, so
the port cannot import it): the reference's YAML configs load unchanged,
and ``get()`` takes a default.
"""

from __future__ import annotations

from typing import Any, Optional

import yaml


class AttrDict(dict):
    """Dict with attribute access, recursive over nested dicts and lists."""

    def __init__(self, mapping=None, **kwargs):
        super().__init__()
        for key, value in dict(mapping or {}, **kwargs).items():
            self[key] = value

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any):
        self[name] = value

    def __setitem__(self, name: str, value: Any):
        super().__setitem__(name, _wrap(value))

    def get(self, name: str, default: Any = None) -> Any:
        return super().get(name, default)


def _wrap(value):
    if isinstance(value, dict) and not isinstance(value, AttrDict):
        return AttrDict(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_wrap(v) for v in value)
    return value


def load_config(path: str, overrides: Optional[dict] = None) -> AttrDict:
    """Load a YAML config; ``overrides`` maps dotted paths
    (``"opt.batch_size"``) to values that replace the file's."""
    with open(path) as fin:
        config = AttrDict(yaml.safe_load(fin))
    for key, value in (overrides or {}).items():
        node = config
        *parents, leaf = key.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    return config


def config_to_str(config) -> str:
    """The config as YAML text (tensorboard's config panel)."""
    return yaml.dump(_plain(config))


def _plain(value):
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value
