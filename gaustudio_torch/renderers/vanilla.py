"""VanillaRenderer — standard 3DGS rendering (port of gaustudio_tpu/renderers/vanilla.py)."""

from __future__ import annotations

import torch

from gaustudio_torch import renderers
from gaustudio_torch.ops.sh import eval_sh
from gaustudio_torch.renderers.base import BaseRenderer


@renderers.register("vanilla_renderer")
class VanillaRenderer(BaseRenderer):
    default_conf = {
        "scaling_modifier": 1.0,
        "white_background": False,
        "convert_SHs_python": False,
        "compute_cov3D_python": False,
    }

    def __init__(self, config=None, device="cpu") -> None:
        super().__init__(config, device)
        self.scaling_modifier = self.config["scaling_modifier"]
        self.white_background = self.config["white_background"]
        self.bg_color = (torch.ones(3) if self.white_background else torch.zeros(3)).to(self.device)
        self.convert_SHs_python = self.config["convert_SHs_python"]
        self.compute_cov3D_python = self.config["compute_cov3D_python"]

    def get_gaussians_properties(self, viewpoint_camera, gaussian_model):
        xyz = gaussian_model.get_attribute("xyz")
        opacity = gaussian_model.get_attribute("opacity")
        scales = None
        rotations = None
        cov3D_precomp = None
        if self.compute_cov3D_python:
            cov3D_precomp = gaussian_model.get_covariance(self.scaling_modifier)
        else:
            scales = gaussian_model.get_attribute("scale")
            if scales.shape[-1] == 2:
                # 2DGS checkpoints: pad a flat z-scale
                scales = torch.cat([scales, torch.zeros_like(scales[:, :1]) + 1e-7], dim=-1)
            rotations = gaussian_model.get_attribute("rot")

        shs = None
        colors_precomp = None
        if self.convert_SHs_python:
            shs_view = gaussian_model.get_features.transpose(1, 2)  # [N, 3, K]
            dir_pp = xyz - viewpoint_camera.camera_center.to(xyz.device)[None, :]
            dir_pp = dir_pp / torch.clamp_min(torch.linalg.norm(dir_pp, dim=1, keepdim=True), 1e-12)
            sh2rgb = eval_sh(gaussian_model.active_sh_degree, shs_view, dir_pp)
            colors_precomp = torch.clamp_min(sh2rgb + 0.5, 0.0)
        else:
            shs = gaussian_model.get_features
        return xyz, shs, colors_precomp, opacity, scales, rotations, cov3D_precomp
