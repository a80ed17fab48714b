"""Initializers registry (port of gaustudio_tpu/pipelines/initializers/__init__.py):
the JAX package's twelve names, ``pcd``, ``depth``, ``dust3r``,
``gaussiansky``, ``multigaussiansky``, ``mesh``, ``voxel``, ``tsdf``,
``VisualHull``, ``colmap``, ``hloc`` and ``loftr``. ``depth``, ``tsdf``,
``VisualHull`` and ``dust3r`` compute on ``device`` (None: the current CUDA
device); the rest on the host.
"""

from gaustudio_torch.registry import Registry

_registry = Registry("initializers")
register = _registry.register
make = _registry.make
keys = _registry.keys

from gaustudio_torch.pipelines.initializers import (  # noqa: E402,F401
    base, pcd, depth, dust3r, gaussiansky, mesh, mask, colmap,
)
