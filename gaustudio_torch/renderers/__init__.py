"""Renderers registry (port of gaustudio_tpu/renderers/__init__.py; vanilla and surfel)."""

from gaustudio_torch.registry import Registry

_registry = Registry("renderers")
register = _registry.register
make = _registry.make

from gaustudio_torch.renderers import vanilla  # noqa: E402,F401
from gaustudio_torch.renderers import surfel  # noqa: E402,F401
