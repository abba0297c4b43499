"""Name-keyed reflection factory (the reference's UniversalFactory,
utils/universal_factory.py:13-44): instantiate a registered class from a config
dict whose "name" selects the class, filtering kwargs by the constructor
signature and recursively building nested name-keyed sub-configs. A copy of
`nfopp_tpu/utils/factory.py` (host-only Python)."""
from __future__ import annotations

import inspect
from typing import Any, Iterable, Mapping

__all__ = ["UniversalFactory"]


class UniversalFactory:
    def __init__(self, classes: Iterable[type] = ()):
        self._registry: dict[str, type] = {c.__name__: c for c in classes}

    def register(self, cls: type) -> type:
        """Usable as a decorator."""
        self._registry[cls.__name__] = cls
        return cls

    def names(self) -> list[str]:
        return sorted(self._registry)

    def make_from_parameters(self, parameters: Mapping, **extra_kwargs: Any) -> Any:
        """Build registry[parameters['name']](**filtered kwargs).

        Config keys are filtered against the constructor signature; values that
        are themselves name-keyed dicts are built recursively; `extra_kwargs`
        supply runtime objects (oracles, optimizers) and win over config keys.
        """
        name = parameters.get("name") or parameters.get("type")
        if name is None:
            raise ValueError("parameters need a 'name' (or 'type') key")
        try:
            cls = self._registry[name]
        except KeyError as exc:
            raise KeyError(f"unknown class {name!r}; registered: {self.names()}") from exc

        signature = inspect.signature(cls.__init__)
        accepted = set(signature.parameters) - {"self"}
        kwargs: dict[str, Any] = {}
        for key, value in parameters.items():
            if key in ("name", "type") or key not in accepted:
                continue
            if isinstance(value, Mapping) and ("name" in value or "type" in value):
                value = self.make_from_parameters(value)
            kwargs[key] = value
        for key, value in extra_kwargs.items():
            if key in accepted:
                kwargs[key] = value
        return cls(**kwargs)
