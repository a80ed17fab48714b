"""Datasets registry (port of gaustudio_tpu/datasets/__init__.py): the JAX
package's nineteen names. ``colmap``, ``vanilla`` (cameras.json + images/)
and ``nerf`` (nerf-synthetic) have modules of their own; the other sixteen
(nerfstudio, mushroom, neus, nsvf, deepvoxels, scannet, polycam, kiri, navi,
mobilebrick, mvsnet, nero, nisr, waymo, rtmv, trellis) are in
``more_formats``. Every loader keeps its cameras on the host.
"""

from gaustudio_torch.registry import Registry

_registry = Registry("datasets")
register = _registry.register
make = _registry.make
keys = _registry.keys

from gaustudio_torch.datasets import colmap, more_formats, nerf, vanilla  # noqa: E402,F401
