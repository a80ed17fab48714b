"""VanillaPointCloud — the standard 3DGS model (port of gaustudio_tpu/models/vanilla.py).

Attributes xyz(3), opacity(1), f_dc(3), f_rest(45), scale(3), rot(4) with
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
)
from gaustudio_torch.utils import ply as plyio

_ELEMS = ("xyz", "opacity", "f_dc", "f_rest", "scale", "rot")


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

    def __init__(self, config=None, device="cpu") -> None:
        super().__init__(config, device)
        self.active_sh_degree = 0
        self.max_sh_degree = self.config["sh_degree"]
        resume_path = self.config.get("resume_path", None)
        if resume_path is not None:
            self.load(resume_path)

    @classmethod
    def from_jax_params(cls, params: Dict[str, np.ndarray], device="cpu",
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
