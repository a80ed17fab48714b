"""Visual-hull initializer (port of
gaustudio_tpu/pipelines/initializers/mask.py): a grid about the cameras'
centre, carved view by view by ``Camera.insideView`` on ``device``, meshed
by marching tetrahedra on ``device``, and placed as the ``mesh`` initializer
places a mesh.

The grid is the JAX package's: ``resolution`` float32 steps of
``linspace(-r, r)`` with r = ``getNerfppNorm``'s ``min_radius`` x
``radius_scale``, ``meshgrid(indexing="ij")``, plus the centre in float64,
then float32. A view carves every point it does not see inside its mask,
the points outside its frustum too; a view without a mask carves only
those.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from gaustudio_torch.pipelines import initializers
from gaustudio_torch.pipelines.initializers.base import BaseInitializer
from gaustudio_torch.pipelines.initializers.mesh import MeshInitializer
from gaustudio_torch.utils.misc import resolve_device


@initializers.register("VisualHull")
class VisualHullInitializer(BaseInitializer):
    def __init__(self, initializer_config, device=None):
        super().__init__(initializer_config, resolve_device(device))
        self.resolution = int(self.initializer_config.get("resolution", 128))
        self.radius_scale = float(self.initializer_config.get("radius_scale", 1.0))

    def __call__(self, model, dataset=None, overwrite=False):
        self.cache_dataset(dataset)
        return self.build_model(model)

    def cache_dataset(self, dataset):
        from gaustudio_torch.datasets.utils import getNerfppNorm
        from gaustudio_torch.ops import mcubes

        norm = getNerfppNorm(list(dataset))
        center = -norm["translate"]
        radius = norm["min_radius"] * self.radius_scale

        res = self.resolution
        lin = torch.from_numpy(np.linspace(-radius, radius, res, dtype=np.float32)).to(self.device)
        grid = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
        pts = (grid.double() + torch.from_numpy(center).to(self.device)).float()

        occupancy = torch.ones(len(pts), dtype=torch.float32, device=self.device)
        for camera in dataset:
            camera = copy.copy(camera).to(self.device)  # the dataset keeps its host tensors
            occupancy[~camera.insideView(pts, camera.mask)] = 0.0

        field = 0.5 - occupancy.reshape(res, res, res)  # negative inside
        self.mesh = mcubes.marching_tetrahedra(field, 0.0, origin=center - radius,
                                               voxel_size=2 * radius / (res - 1), slab=4)

    def build_model(self, model):
        if len(self.mesh[0]) == 0:
            raise ValueError("visual hull carving produced an empty surface")
        return MeshInitializer(self.initializer_config)(model, mesh=self.mesh)
