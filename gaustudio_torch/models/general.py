"""GeneralPointCloud — a plain xyz / rgb / normal cloud (port of
gaustudio_tpu/models/general.py)."""

from __future__ import annotations

import numpy as np

from gaustudio_torch import models
from gaustudio_torch.models.base import BasePointCloud
from gaustudio_torch.utils import ply as plyio


@models.register("general_pcd")
class GeneralPointCloud(BasePointCloud):
    default_conf = {"attributes": {"xyz": 3, "rgb": 3, "normal": 3}}

    def export(self, path):
        """xyz, normals (zeros where the cloud has none) and uint8 RGB (white
        where it has none, as a vanilla model colours a cloud given none).
        The JAX export raises for a cloud without colours, such as the mesh
        and visual-hull initializers build."""
        xyz = self._xyz.detach().cpu().numpy()
        rgb = getattr(self, "_rgb", None)
        rgb = (rgb.detach().cpu().numpy() if rgb is not None and len(rgb)
               else np.ones_like(xyz))
        rgb = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
        normal = getattr(self, "_normal", None)
        normal = (normal.detach().cpu().numpy() if normal is not None and len(normal)
                  else np.zeros_like(xyz))
        plyio.store_ply(path, xyz, rgb, normal)
        print(f"Exported {len(xyz)} points to {path}")
