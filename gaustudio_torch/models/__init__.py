"""Models registry (port of gaustudio_tpu/models/__init__.py)."""

from gaustudio_torch.registry import Registry

_registry = Registry("models")
register = _registry.register
make = _registry.make

from gaustudio_torch.models import vanilla, general, mip, scaffold, sap  # noqa: E402,F401
