"""Optimizers registry (port of gaustudio_tpu/pipelines/optimizers/__init__.py)."""

from gaustudio_torch.registry import Registry

_registry = Registry("optimizers")
register = _registry.register
make = _registry.make

from gaustudio_torch.pipelines.optimizers import general  # noqa: E402,F401
