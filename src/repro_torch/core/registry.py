"""String-keyed class registry (the port's copy of ``repro.core.registry``)."""

from __future__ import annotations


class Registry:
    """Register classes under a string key; construct them by name."""

    def __init__(self, kind: str):
        self.kind = kind
        self.items: dict[str, type] = {}

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
        if name not in self.items:
            raise ValueError(
                f"unknown {self.kind} {name!r}; registered: {self.names()}"
            )
        return self.items[name](**kwargs)
