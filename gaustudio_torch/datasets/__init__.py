"""Datasets registry (port of gaustudio_tpu/datasets/__init__.py).

The port reads the vanilla (cameras.json + images/) and nerf-synthetic
layouts; the COLMAP reader comes in a later slice.
"""

from gaustudio_torch.registry import Registry

_registry = Registry("datasets")
register = _registry.register
make = _registry.make

from gaustudio_torch.datasets import nerf, vanilla  # noqa: E402,F401
