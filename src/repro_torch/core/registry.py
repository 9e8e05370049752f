"""String-keyed class registry (the port's copy of ``repro.core.registry``)."""

from __future__ import annotations

from typing import Mapping, Optional


class Registry:
    """Register classes under a string key; construct them by name.

    ``items`` is the live dict; ``aliases`` maps legacy names onto keys.
    """

    def __init__(self, kind: str, aliases: Optional[Mapping[str, str]] = None):
        self.kind = kind
        self.items: dict[str, type] = {}
        self.aliases = dict(aliases or {})

    def register(self, name: str):
        """Class decorator: register ``cls`` under ``name`` and stamp
        ``cls.name`` (duplicate names are a programming error)."""

        def deco(cls: type) -> type:
            if name in self.items:
                raise ValueError(f"{self.kind} {name!r} already registered")
            cls.name = name
            self.items[name] = cls
            return cls

        return deco

    def names(self) -> list[str]:
        return sorted(self.items)

    def get(self, name: str, **kwargs):
        key = self.aliases.get(name, name)
        if key not in self.items:
            raise ValueError(
                f"unknown {self.kind} {name!r}; registered: {self.names()}"
            )
        return self.items[key](**kwargs)

    def resolve(self, obj, base: type, **kwargs):
        """Accept a registry name (constructed with ``kwargs``) or an
        instance of ``base`` (passed through; ``kwargs`` then illegal)."""
        if isinstance(obj, str):
            return self.get(obj, **kwargs)
        if kwargs:
            raise ValueError(f"{self.kind} kwargs only apply to string-keyed names")
        if isinstance(obj, base):
            return obj
        raise ValueError(f"not a {self.kind}: {obj!r}")
