"""Background sky shells (port of
gaustudio_tpu/pipelines/initializers/gaussiansky.py): inward-facing
Gaussians on Fibonacci spheres, drawn in float64 and kept as float32. Host
numpy; the model keeps the attributes on its device."""

from __future__ import annotations

import math

import numpy as np

from gaustudio_torch.pipelines import initializers
from gaustudio_torch.pipelines.initializers.base import (
    BaseInitializer,
    inverse_sigmoid_np,
    normal2rotation,
)


def fibonacci_sphere(samples: int = 1):
    """``samples`` points of the unit Fibonacci sphere and their inward
    normals, float32 [samples, 3] each."""
    phi = math.pi * (3.0 - math.sqrt(5.0))
    i = np.arange(samples, dtype=np.float64)
    y = 1 - (i / max(samples - 1, 1)) * 2
    radius = np.sqrt(np.maximum(1 - y * y, 0))
    theta = phi * i
    x = np.cos(theta) * radius
    z = np.sin(theta) * radius
    points = np.stack([x, y, z], -1)
    normals = -points / np.maximum(np.linalg.norm(points, axis=-1, keepdims=True), 1e-12)
    return points.astype(np.float32), normals.astype(np.float32)


def _shell_attributes(resolution, radius, color=0.5):
    n = resolution ** 2
    xyz, normals = fibonacci_sphere(n)
    xyz = xyz * radius
    # the spacing of neighbours on the sphere sets the scale
    spacing = 2 * math.pi * radius / (resolution * math.sqrt(math.pi))
    scale = np.full((n, 3), np.log(max(spacing, 1e-6)), np.float32)
    rot = normal2rotation(normals)
    opacity = inverse_sigmoid_np(0.5 * np.ones((n, 1), np.float32))
    rgb = np.full((n, 3), color, np.float32)
    return xyz, rgb, scale, rot, opacity


@initializers.register("gaussiansky")
class GaussianSkyInitializer(BaseInitializer):
    """One shell of ``resolution``² grey Gaussians at ``radius``."""

    def __init__(self, initializer_config, device=None):
        super().__init__(initializer_config, device)
        self.resolution = int(self.initializer_config.get("resolution", 100))
        self.radius = float(self.initializer_config.get("radius", 100.0))

    def build_model(self, model):
        xyz, rgb, scale, rot, opacity = _shell_attributes(self.resolution, self.radius)
        model.create_from_attribute(xyz=xyz, rgb=rgb, scale=scale, rot=rot, opacity=opacity)
        return model


@initializers.register("multigaussiansky")
class MultiGaussianSkyInitializer(BaseInitializer):
    """Nested shells, one at each of ``radii``."""

    def __init__(self, initializer_config, device=None):
        super().__init__(initializer_config, device)
        self.resolution = int(self.initializer_config.get("resolution", 100))
        self.radii = self.initializer_config.get("radii", [50.0, 100.0, 200.0])

    def build_model(self, model):
        parts = [_shell_attributes(self.resolution, r) for r in self.radii]
        xyz, rgb, scale, rot, opacity = (np.concatenate([p[i] for p in parts]) for i in range(5))
        model.create_from_attribute(xyz=xyz, rgb=rgb, scale=scale, rot=rot, opacity=opacity)
        return model
