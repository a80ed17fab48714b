"""Shared register/make decorator registry (port of gaustudio_tpu/registry.py)."""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    """A name -> class registry with the reference's make() semantics."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: str) -> Callable:
        def decorator(cls):
            self._entries[name] = cls
            return cls

        return decorator

    def make(self, config, **kwargs):
        """Instantiate a registered class from a name or a config mapping.

        A bare string is a name with empty config; otherwise
        ``config['name']`` selects the class and the whole mapping is passed
        to its constructor. ``kwargs`` (e.g. ``device``) go to the
        constructor as well.
        """
        if isinstance(config, str):
            name = config
            config = {}
        else:
            name = config.get("name")
        if not name:
            raise ValueError(f"{self.kind} name is required")
        if name not in self._entries:
            raise ValueError(f"Unknown {self.kind}: {name}")
        return self._entries[name](config, **kwargs)
