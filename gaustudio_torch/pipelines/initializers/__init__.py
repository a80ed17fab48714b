"""Initializers registry (port of gaustudio_tpu/pipelines/initializers/__init__.py).

The port has the mesh initializers (``mesh``, ``voxel``, ``tsdf``); the
other seven of the JAX package come with gs-init in a later slice.
"""

from gaustudio_torch.registry import Registry

_registry = Registry("initializers")
register = _registry.register
make = _registry.make

from gaustudio_torch.pipelines.initializers import base, mesh  # noqa: E402,F401
