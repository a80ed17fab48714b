"""PCDRenderer — a plain RGB point cloud drawn as small fixed-size Gaussians
(port of gaustudio_tpu/renderers/pcd.py)."""

from __future__ import annotations

import torch

from gaustudio_torch import renderers
from gaustudio_torch.renderers.base import BaseRenderer


@renderers.register("pcd_renderer")
class PCDRenderer(BaseRenderer):
    default_conf = {
        "kernel_size": 0.01,
        "scaling_modifier": 1.0,
        "white_background": False,
        "debug": False,
    }

    def __init__(self, config=None, device=None) -> None:
        super().__init__(config, device)
        self.kernel_size = self.config["kernel_size"]
        self.scaling_modifier = self.config["scaling_modifier"]
        self.white_background = self.config["white_background"]
        self.bg_color = (torch.ones(3) if self.white_background else torch.zeros(3)).to(self.device)

    def get_gaussians_properties(self, viewpoint_camera, gaussian_model):
        """Scale ``kernel_size``, the identity rotation, opacity 1, and the
        ``rgb`` attribute as colour (divided by 255 where any value is above 1)."""
        xyz = gaussian_model.get_attribute("xyz")
        n = xyz.shape[0]
        rgb = gaussian_model.get_attribute("rgb")
        if float(rgb.max()) > 1.0 + 1e-6:
            rgb = rgb / 255.0
        opacity = torch.ones((n, 1), device=xyz.device)
        scales = torch.full((n, 3), self.kernel_size, device=xyz.device)
        rotations = torch.zeros((n, 4), device=xyz.device)
        rotations[:, 0] = 1.0
        return xyz, None, rgb, opacity, scales, rotations, None
