"""SurfelRenderer — 2DGS rendering (port of gaustudio_tpu/renderers/surfel.py).

Output decode of the JAX package: expected depth = depth sum / max(alpha,
1e-9), view normals rotated to world, the median and distortion buffers.
"""

from __future__ import annotations

import torch

from gaustudio_torch import renderers
from gaustudio_torch.ops import rasterize_surfel
from gaustudio_torch.ops.gaussian import transform_dirs
from gaustudio_torch.ops.sh import eval_sh
from gaustudio_torch.renderers.base import BaseRenderer
from gaustudio_torch.utils.observability import annotate


@renderers.register("surfel_renderer")
class SurfelRenderer(BaseRenderer):
    default_conf = {
        "scaling_modifier": 1.0,
        "white_background": False,
        "convert_SHs_python": False,
    }

    def __init__(self, config=None, device=None) -> None:
        super().__init__(config, device)
        self.scaling_modifier = self.config["scaling_modifier"]
        self.white_background = self.config["white_background"]
        self.bg_color = (torch.ones(3) if self.white_background else torch.zeros(3)).to(self.device)
        self.convert_SHs_python = self.config["convert_SHs_python"]

    def get_gaussians_properties(self, viewpoint_camera, gaussian_model):
        xyz = gaussian_model.get_attribute("xyz")
        opacity = gaussian_model.get_attribute("opacity")
        scales = gaussian_model.get_attribute("scale")
        if scales.shape[-1] == 3:
            scales = scales[:, :2]
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
        return xyz, shs, colors_precomp, opacity, scales, rotations, None

    def dp_render_closure(self, cameras, gaussian_model):
        """The camera-parallel closure over the surfel rasterizer; it maps
        ``rendered_alpha`` to the fusion's ``rendered_final_opacity``."""
        with torch.inference_mode():
            xyz, shs, colors_precomp, opacity, scales, rotations, _ = (
                self.get_gaussians_properties(cameras[0], gaussian_model))
        settings = self.make_settings(cameras[0], gaussian_model, xyz.device)
        active_deg = getattr(gaussian_model, "active_sh_degree", None)

        @torch.inference_mode()
        def render_fn(s):
            out = dict(rasterize_surfel.rasterize_surfels(
                xyz, opacity, s, scales=scales, rotations=rotations, shs=shs,
                colors_precomp=colors_precomp,
                active_sh_degree=active_deg if shs is not None else None))
            out["rendered_final_opacity"] = out["rendered_alpha"]
            return out

        return settings, render_fn

    @torch.inference_mode()
    def render(self, viewpoint_camera, gaussian_model):
        """Render one camera; returns the JAX surfel renderer's output dict."""
        with annotate("gs.render"):
            xyz, shs, colors_precomp, opacity, scales, rotations, _ = (
                self.get_gaussians_properties(viewpoint_camera, gaussian_model))
            settings = self.make_settings(viewpoint_camera, gaussian_model, xyz.device)
            active_deg = getattr(gaussian_model, "active_sh_degree", None)
            out = rasterize_surfel.rasterize_surfels(
                xyz, opacity, settings, scales=scales, rotations=rotations, shs=shs,
                colors_precomp=colors_precomp,
                active_sh_degree=active_deg if shs is not None else None)
            alpha = out["rendered_alpha"]
            depth = torch.nan_to_num(out["rendered_depth_sum"] / torch.clamp_min(alpha, 1e-9),
                                     0.0, 0.0)
            # view normals to world, n @ R per pixel with R the rotation block of
            # the transposed world -> view matrix; written out, so no TF32 matmul
            n_world = transform_dirs(out["rendered_normal_view"].permute(1, 2, 0),
                                     settings.viewmatrix[:3, :3])
            return {
                "render": out["render"],
                "rendered_normal": n_world.permute(2, 0, 1),
                "rendered_depth": depth,
                "rendered_median_depth": out["rendered_median_depth"],
                "rendered_median_weight": out["rendered_median_weight"],
                "rendered_median_id": out["rendered_median_id"],
                "rendered_dist_m1": out["rendered_dist_m1"],
                "rendered_dist_m2": out["rendered_dist_m2"],
                "viewspace_points": torch.zeros((xyz.shape[0], 2), device=xyz.device),
                "visibility_filter": out["radii"] > 0,
                "rendered_final_opacity": alpha,
                "radii": out["radii"],
                "n_contrib": out["n_contrib"],
                "num_rendered": out["num_rendered"],
            }
