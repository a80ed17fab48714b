"""Datasets registry (port of gaustudio_tpu/datasets/__init__.py).

The port reads COLMAP scenes, the vanilla (cameras.json + images/) layout and
the nerf-synthetic layout; the other formats belong to a later slice.
"""

from gaustudio_torch.registry import Registry

_registry = Registry("datasets")
register = _registry.register
make = _registry.make

from gaustudio_torch.datasets import colmap, nerf, vanilla  # noqa: E402,F401
