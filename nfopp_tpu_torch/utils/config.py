"""Config plumbing: attribute-style dicts + recursive JSON overrides (copied
from `nfopp_tpu/utils/config.py`, which is host-only Python; importing it
would run `nfopp_tpu/__init__.py`, which imports JAX).

Replaces the reference's pytorch_lightning `AttributeDict` dependency and its
`utils/config.py:24-37` recursive merge (used to fold a benchmark settings
JSON's "nfomp" section over script defaults, scripts/run_bench_mr.py:80-85).
"""
from __future__ import annotations

import json
from typing import Any, Mapping

__all__ = ["AttributeDict", "deep_update", "Config"]


class AttributeDict(dict):
    """dict with attribute access; nested dicts are wrapped on access."""

    def __getattr__(self, key: str) -> Any:
        try:
            value = self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc
        if isinstance(value, dict) and not isinstance(value, AttributeDict):
            value = AttributeDict(value)
            self[key] = value
        return value

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value


def deep_update(base: dict, override: Mapping) -> dict:
    """Recursively merge `override` into `base` (in place), returning base.

    Scalars/lists replace; nested dicts merge key-by-key — the reference's
    Config.update semantics (utils/config.py:24-37).
    """
    for key, value in override.items():
        if isinstance(value, Mapping) and isinstance(base.get(key), dict):
            deep_update(base[key], value)
        else:
            base[key] = value
    return base


class Config:
    """A mutable configuration tree with JSON override support."""

    def __init__(self, data: dict | None = None):
        self._data: dict = dict(data) if data else {}

    @classmethod
    def from_dict(cls, data: Mapping) -> "Config":
        return cls(json.loads(json.dumps(dict(data))))

    @classmethod
    def from_json_file(cls, path: str) -> "Config":
        with open(path) as fd:
            return cls(json.load(fd))

    def update(self, override: Mapping) -> "Config":
        deep_update(self._data, override)
        return self

    def as_attribute_dict(self) -> AttributeDict:
        def wrap(value):
            if isinstance(value, dict):
                return AttributeDict({k: wrap(v) for k, v in value.items()})
            return value

        return wrap(self._data)

    def as_dict(self) -> dict:
        return json.loads(json.dumps(self._data))
