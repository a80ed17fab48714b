"""Mesh initializers: SuGaR barycentric placement, surface voxels and TSDF
fusion of a dataset's depth maps (port of
gaustudio_tpu/pipelines/initializers/mesh.py).

A mesh is a tuple (vertices, faces[, vertex colours]) of arrays. ``mesh``
and ``voxel`` compute on the host in numpy, as the JAX package does, and
hand the attributes to the model, which keeps them on its device; ``tsdf``
fuses the depth maps on ``device`` with the port's TSDF and marching
tetrahedra.
"""

from __future__ import annotations

import numpy as np

from gaustudio_torch.pipelines import initializers
from gaustudio_torch.pipelines.initializers.base import (
    BaseInitializer,
    inverse_sigmoid_np,
    normal2rotation,
)
from gaustudio_torch.utils import mesh as meshu
from gaustudio_torch.utils.misc import resolve_device

# Gaussians a triangle -> (disc radius over the shortest edge, barycentric
# positions)
_BARY_SETUPS = {
    1: (1.0 / 2.0 / np.sqrt(3.0), [[1 / 3, 1 / 3, 1 / 3]]),
    3: (
        1.0 / 2.0 / (np.sqrt(3.0) + 1.0),
        [[1 / 2, 1 / 4, 1 / 4], [1 / 4, 1 / 2, 1 / 4], [1 / 4, 1 / 4, 1 / 2]],
    ),
    4: (
        1.0 / (4.0 * np.sqrt(3.0)),
        [[1 / 3, 1 / 3, 1 / 3], [2 / 3, 1 / 6, 1 / 6],
         [1 / 6, 2 / 3, 1 / 6], [1 / 6, 1 / 6, 2 / 3]],
    ),
    6: (
        1.0 / (4.0 + 2.0 * np.sqrt(3.0)),
        [[2 / 3, 1 / 6, 1 / 6], [1 / 6, 2 / 3, 1 / 6], [1 / 6, 1 / 6, 2 / 3],
         [1 / 6, 5 / 12, 5 / 12], [5 / 12, 1 / 6, 5 / 12], [5 / 12, 5 / 12, 1 / 6]],
    ),
}


@initializers.register("mesh")
class MeshInitializer(BaseInitializer):
    """SuGaR-style placement: 1, 3, 4 or 6 flat Gaussians a triangle at
    fixed barycentric positions, each a disc in the triangle's plane
    (log scale z = log(1e-7)) sized from its shortest edge, nearly opaque."""

    n_gaussians_per_surface_triangle = 1

    def __init__(self, initializer_config, device=None):
        super().__init__(initializer_config, device)
        npg = int(self.initializer_config.get("n_gaussians_per_triangle",
                                              self.n_gaussians_per_surface_triangle))
        if npg not in _BARY_SETUPS:
            raise ValueError(f"n_gaussians_per_triangle must be one of {list(_BARY_SETUPS)}")
        self.n_gaussians_per_surface_triangle = npg
        radius, bary = _BARY_SETUPS[npg]
        self.surface_triangle_circle_radius = radius
        self.surface_triangle_bary_coords = np.asarray(bary, np.float32)  # [G, 3]
        self.mesh = None

    def __call__(self, model, mesh=None, dataset=None, overwrite=False):
        if mesh is not None:
            self.mesh = mesh
        return self.build_model(model)

    def build_model(self, model):
        vertices = np.asarray(self.mesh[0], np.float32)
        faces = np.asarray(self.mesh[1], np.int64)
        vertex_colors = self.mesh[2] if len(self.mesh) > 2 else None
        vn = meshu.vertex_normals(vertices, faces)

        fv = vertices[faces]  # [F, 3, 3]
        bary = self.surface_triangle_bary_coords  # [G, 3]
        points = np.einsum("gk,fkc->fgc", bary, fv).reshape(-1, 3)
        normals = np.einsum("gk,fkc->fgc", bary, vn[faces]).reshape(-1, 3)
        normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)
        rotations = normal2rotation(normals)

        colors = None
        if vertex_colors is not None and len(vertex_colors):
            fc = np.asarray(vertex_colors, np.float32)[faces]
            colors = np.einsum("gk,fkc->fgc", bary, fc).reshape(-1, 3)

        # discs from the shortest edge, flat along the normal
        edges = np.linalg.norm(fv - fv[:, [1, 2, 0]], axis=-1)
        s = np.clip(edges.min(axis=-1) * self.surface_triangle_circle_radius, 0, None)
        s = np.repeat(s, self.n_gaussians_per_surface_triangle)
        scales = np.log(np.stack([s, s, np.zeros_like(s)], axis=1) * 2 + 1e-7).astype(np.float32)

        opacity = inverse_sigmoid_np(np.full((points.shape[0], 1), 1.0 - 1e-6, np.float32))
        model.create_from_attribute(xyz=points.astype(np.float32), rgb=colors, scale=scales,
                                    opacity=opacity, rot=rotations)
        return model


@initializers.register("voxel")
class VoxelInitializer(BaseInitializer):
    """Gaussians at the centres of the voxels a mesh's surface crosses,
    found from area-weighted surface samples (``default_rng(0)``)."""

    def __init__(self, initializer_config, device=None):
        super().__init__(initializer_config, device)
        self.voxel_size = float(self.initializer_config.get("voxel_size", 0.02))
        self.mesh = None

    def __call__(self, model, mesh=None, dataset=None, overwrite=False):
        if mesh is not None:
            self.mesh = mesh
        return self.build_model(model)

    def build_model(self, model):
        vertices, faces = np.asarray(self.mesh[0]), np.asarray(self.mesh[1])
        rng = np.random.default_rng(0)
        v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
        areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
        n_samples = max(int(areas.sum() / self.voxel_size ** 2 * 4), len(faces))
        tri = rng.choice(len(faces), n_samples, p=areas / areas.sum())
        r1 = np.sqrt(rng.uniform(size=(n_samples, 1)))
        r2 = rng.uniform(size=(n_samples, 1))
        pts = (1 - r1) * v0[tri] + r1 * (1 - r2) * v1[tri] + r1 * r2 * v2[tri]
        keys = np.floor(pts / self.voxel_size).astype(np.int64)
        _, idx = np.unique(keys, axis=0, return_index=True)
        centers = (keys[idx] + 0.5) * self.voxel_size

        opacity = inverse_sigmoid_np(0.1 * np.ones((len(centers), 1), np.float32))
        scale = np.full((len(centers), 3), np.log(self.voxel_size / 2), np.float32)
        model.create_from_attribute(xyz=centers.astype(np.float32), rgb=None, scale=scale,
                                    opacity=opacity)
        return model


@initializers.register("tsdf")
class TsdfInitializer(BaseInitializer):
    """The depth maps of a dataset fused into a TSDF on ``device`` (None:
    the current CUDA device), meshed, then placed as ``mesh`` places them."""

    def __init__(self, initializer_config, device=None):
        super().__init__(initializer_config, resolve_device(device))
        self.voxel_size = float(self.initializer_config.get("voxel_length", 0.01))
        self.sdf_trunc = float(self.initializer_config.get("sdf_trunc", 0.04))
        self.mesh = None

    def __call__(self, model, dataset=None, overwrite=False):
        self.cache_dataset(dataset)
        return self.build_model(model)

    def cache_dataset(self, dataset):
        from gaustudio_torch.ops import mcubes, tsdf

        lo, hi = None, None
        cameras = [camera for camera in dataset if camera.depth is not None]
        for camera in cameras:
            world = camera.depth2point(camera.depth, "world")
            w = world[camera.depth.to(world.device) > 0]
            if len(w):
                wlo, whi = w.amin(0).cpu().numpy(), w.amax(0).cpu().numpy()
                lo = wlo if lo is None else np.minimum(lo, wlo)
                hi = whi if hi is None else np.maximum(hi, whi)
        if lo is None:
            raise ValueError("tsdf initializer: dataset has no depth maps")

        vol = tsdf.volume_from_bounds(lo, hi, self.voxel_size, self.sdf_trunc, max_dim=256,
                                      device=self.device)
        for camera in cameras:
            tsdf.integrate(vol, camera.depth, camera.intrinsics, camera.extrinsics)
        self.mesh = mcubes.marching_tetrahedra(
            vol.tsdf, 0.0, weight=vol.weight, min_weight=1.0, origin=vol.origin.cpu().numpy(),
            voxel_size=float(vol.voxel_size), slab=4)

    def build_model(self, model):
        return MeshInitializer(self.initializer_config)(model, mesh=self.mesh)
