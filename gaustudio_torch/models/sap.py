"""ShapeAsPoints: differentiable Poisson surface reconstruction as a model
(port of gaustudio_tpu/models/sap.py).

The points live in sigmoid space (inverse-sigmoid coordinates of their
positions in the unit cube, with a 1.2x margin) beside their normals, as
tensors on the model's device; ``generate_mesh`` runs DPSR -> tanh ->
marching tetrahedra and maps the vertices back to world space. It is the
``--meshing sap`` backend of gs-extract-pcd.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gaustudio_torch import models
from gaustudio_torch.models.base import BasePointCloud
from gaustudio_torch.models.utils import inverse_sigmoid
from gaustudio_torch.ops import dpsr as dpsr_ops


@models.register("sap_pcd")
class ShapeAsPoints(BasePointCloud):
    default_conf = {
        "attributes": {"xyz": 3, "normal": 3},
        "grid_res": 128,
        "psr_sigma": 2.0,
        "zero_level": 0.0,
    }

    def setup(self, num_points: int = 0):
        super().setup(num_points)
        self._center = np.zeros(3, np.float32)
        self._scale_factor = 1.0

    @classmethod
    def from_pointcloud(cls, xyz, normals, config=None, device=None) -> "ShapeAsPoints":
        """Points and normals (arrays or tensors) -> a model on ``device``
        (None: the current CUDA device). The points are normalised into the
        unit cube on the host, centred, with a 1.2x margin."""
        obj = cls(config, device)
        xyz = _host(xyz)
        center = (xyz.min(0) + xyz.max(0)) / 2
        scale = float(np.max(xyz.max(0) - xyz.min(0))) * 1.2 + 1e-6
        unit = np.clip((xyz - center) / scale + 0.5, 1e-4, 1 - 1e-4)  # in ~(0.08, 0.92)
        obj._xyz = inverse_sigmoid(torch.from_numpy(unit)).to(obj.device)
        obj._normal = obj._as_tensor(_host(normals))
        obj.num_points = len(xyz)
        obj._center = center
        obj._scale_factor = scale
        return obj

    @classmethod
    def from_mesh(cls, vertices, faces, n_samples: int = 100000, config=None, seed: int = 0,
                  device=None) -> "ShapeAsPoints":
        """Oriented points sampled from a mesh's surface, by area, with
        ``numpy.random.default_rng(seed)`` on the host."""
        rng = np.random.default_rng(seed)
        v = np.asarray(vertices, np.float32)
        f = np.asarray(faces, np.int64)
        v0, v1, v2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        fn = np.cross(v1 - v0, v2 - v0)
        areas = 0.5 * np.linalg.norm(fn, axis=1)
        tri = rng.choice(len(f), size=n_samples, p=areas / areas.sum())
        r1 = np.sqrt(rng.uniform(size=(n_samples, 1)))
        r2 = rng.uniform(size=(n_samples, 1))
        pts = ((1 - r1) * v0[tri] + r1 * (1 - r2) * v1[tri] + r1 * r2 * v2[tri]).astype(np.float32)
        nrm = fn[tri] / np.maximum(np.linalg.norm(fn[tri], axis=1, keepdims=True), 1e-12)
        return cls.from_pointcloud(pts, nrm.astype(np.float32), config, device)

    @property
    def unit_points(self) -> torch.Tensor:
        return 1.0 / (1.0 + torch.exp(-self._xyz))

    def psr_grid(self) -> torch.Tensor:
        """tanh of the DPSR indicator grid [R, R, R] on the model's device."""
        res = int(self.config["grid_res"])
        phi = dpsr_ops.dpsr_solve(self.unit_points, self._normal, (res, res, res),
                                  sig=float(self.config["psr_sigma"]))
        return torch.tanh(phi)

    def generate_mesh(self) -> Tuple[np.ndarray, np.ndarray]:
        """(vertices float32 [V, 3] in world space, faces [F, 3]) on the host."""
        verts_unit, faces, _ = dpsr_ops.mc_from_psr(
            self.psr_grid(), zero_level=float(self.config["zero_level"]))
        verts = (verts_unit - 0.5) * self._scale_factor + self._center
        return verts.astype(np.float32), faces

    def export(self, path):
        from gaustudio_torch.utils.mesh import save_mesh

        verts, faces = self.generate_mesh()
        save_mesh(path, verts, faces)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)
