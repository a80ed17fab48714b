"""VanillaPointCloud — the standard 3DGS model (port of gaustudio_tpu/models/vanilla.py).

Attributes xyz(3), opacity(1), f_dc(3), f_rest(45), scale(3; 2 for 2DGS), rot(4) with
exp / sigmoid / normalize activations and the Inria checkpoint layout
(x, y, z, nx, ny, nz, f_dc_*, f_rest_*, opacity, scale_*, rot_*).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gaustudio_torch import models
from gaustudio_torch.models.base import BasePointCloud
from gaustudio_torch.models.utils import (
    build_covariance_from_scaling_rotation,
    get_activation,
    inverse_sigmoid,
)
from gaustudio_torch.ops.sh import RGB2SH
from gaustudio_torch.utils import ply as plyio

_ELEMS = ("xyz", "opacity", "f_dc", "f_rest", "scale", "rot")


def calculate_dist2(xyz) -> np.ndarray:
    """Mean squared distance of each point to its 3 nearest neighbours
    (scipy's cKDTree in place of simple_knn's distCUDA2)."""
    from scipy.spatial import cKDTree

    pts = np.asarray(xyz, np.float32)
    dists, _ = cKDTree(pts).query(pts, k=4)
    return (dists[:, 1:] ** 2).mean(axis=1).astype(np.float32)


@models.register("vanilla_pcd")
class VanillaPointCloud(BasePointCloud):
    default_conf = {
        "sh_degree": 3,
        "attributes": {
            "xyz": 3,
            "opacity": 1,
            "f_dc": 3,
            "f_rest": 45,
            "scale": 3,
            "rot": 4,
        },
        "activations": {"scale": "exp", "opacity": "sigmoid", "rot": "normalize"},
    }

    def __init__(self, config=None, device=None) -> None:
        super().__init__(config, device)
        self.active_sh_degree = 0
        self.max_sh_degree = self.config["sh_degree"]
        resume_path = self.config.get("resume_path", None)
        if resume_path is not None:
            self.load(resume_path)

    @classmethod
    def from_jax_params(cls, params: Dict[str, np.ndarray], device=None,
                        config=None) -> "VanillaPointCloud":
        """Build the model from the JAX model's raw attributes.

        ``params`` maps each of xyz, opacity, f_dc, f_rest, scale, rot to
        ``np.asarray(getattr(jax_pcd, "_" + elem))`` and may hold
        ``active_sh_degree``.
        """
        pcd = cls(config, device)
        for elem in _ELEMS:
            setattr(pcd, "_" + elem, pcd._as_tensor(params[elem]))
        pcd.num_points = int(pcd._xyz.shape[0])
        if "active_sh_degree" in params:
            pcd.active_sh_degree = int(params["active_sh_degree"])
        return pcd

    def create_from_attribute(self, xyz, rgb=None, scale=None, rot=None, opacity=None,
                              **_):
        """Initial model of a point cloud: RGB -> SH dc (higher bands 0),
        log-scale from the mean squared distance to the 3 nearest neighbours
        (as wide as the config's ``attributes.scale``),
        identity quaternions, opacity inverse_sigmoid(0.1)."""
        xyz = np.asarray(xyz, np.float32)
        n = xyz.shape[0]
        rgb = np.ones_like(xyz) if rgb is None else np.asarray(rgb, np.float32)
        if scale is None:  # 3 columns, or 2 for 2DGS surfels (attributes.scale)
            sdim = int(self.config.get("attributes", {}).get("scale", 3))
            scale = np.repeat(np.log(np.sqrt(calculate_dist2(xyz) + 1e-7))[:, None], sdim, axis=1)
        if rot is None:
            rot = np.zeros((n, 4), np.float32)
            rot[:, 0] = 1.0
        self._xyz = self._as_tensor(xyz)
        self._f_dc = self._as_tensor(RGB2SH(rgb))
        self._f_rest = torch.zeros((n, ((self.max_sh_degree + 1) ** 2 - 1) * 3),
                                   dtype=torch.float32, device=self.device)
        self._scale = self._as_tensor(scale)
        self._rot = self._as_tensor(rot)
        self._opacity = (inverse_sigmoid(torch.full((n, 1), 0.1)).to(self.device)
                         if opacity is None else self._as_tensor(opacity).reshape(n, 1))
        self.num_points = n

    def oneupSHdegree(self):
        if self.active_sh_degree < self.max_sh_degree:
            self.active_sh_degree += 1

    def get_attribute(self, attribute):
        """Activated attribute."""
        raw = getattr(self, "_" + attribute)
        if attribute in self.config.get("activations", {}):
            return get_activation(self.config["activations"][attribute])(raw)
        return raw

    def get_covariance(self, scaling_modifier=1.0):
        return build_covariance_from_scaling_rotation(
            self.get_attribute("scale"), scaling_modifier, self._rot)

    @property
    def get_features(self) -> torch.Tensor:
        """[N, K, 3] band-major SH coefficients.

        ``_f_rest`` holds the on-disk channel-major layout (f_rest_{c*Kr+k});
        the channel -> band transpose matches Inria's loader, as the JAX
        package does.
        """
        n = self.num_points
        f_dc = self._f_dc.reshape(n, 1, 3)
        f_rest = self._f_rest.reshape(n, 3, -1).transpose(1, 2)
        return torch.cat([f_dc, f_rest], dim=1)

    @property
    def get_opacity(self):
        return self.get_attribute("opacity")

    @property
    def get_scaling(self):
        return self.get_attribute("scale")

    @property
    def get_rotation(self):
        return self.get_attribute("rot")

    @property
    def get_xyz(self):
        return self.get_attribute("xyz")

    @property
    def get_num_points(self):
        return self.num_points

    @property
    def get_features_dc(self):
        return self.get_attribute("f_dc").reshape(self.num_points, -1, 3)

    @property
    def get_features_rest(self):
        return self.get_attribute("f_rest").reshape(self.num_points, -1, 3)

    def export(self, path):
        """Write the Inria-format checkpoint PLY."""
        n = self.num_points
        host = lambda t: t.detach().cpu().numpy().astype(np.float32).reshape(n, -1)
        xyz = host(self._xyz)
        props = {}
        for i, k in enumerate(["x", "y", "z"]):
            props[k] = xyz[:, i]
        for k in ["nx", "ny", "nz"]:
            props[k] = np.zeros(n, np.float32)
        for name, arr in (("f_dc", host(self._f_dc)), ("f_rest", host(self._f_rest))):
            for i in range(arr.shape[1]):
                props[f"{name}_{i}"] = arr[:, i]
        props["opacity"] = host(self._opacity)[:, 0]
        for name, arr in (("scale", host(self._scale)), ("rot", host(self._rot))):
            for i in range(arr.shape[1]):
                props[f"{name}_{i}"] = arr[:, i]
        plyio.write_ply(path, props)
        print(f"Exported {n} points to {path}")
