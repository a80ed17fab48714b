"""BaseRenderer — camera + model -> rendered buffer dict
(port of gaustudio_tpu/renderers/base.py).

Rendering is forward only and runs under ``torch.inference_mode()``; it
takes place on the model's device.
"""

from __future__ import annotations

from typing import Dict

import torch

from gaustudio_torch.ops import rasterize as rast
from gaustudio_torch.ops.rasterize import RasterizeSettings
from gaustudio_torch.utils.misc import resolve_device
from gaustudio_torch.utils.observability import annotate


class BaseRenderer:
    default_conf: Dict = {}
    # a renderer that decodes its Gaussians per camera (Scaffold-GS) cannot
    # hoist them once for a camera-parallel batch
    view_dependent_gaussians = False

    def __init__(self, config=None, device=None):
        """``device``: where the renderer's own tensors live; None is the
        current CUDA device (see utils.misc.resolve_device)."""
        self.config = {**self.default_conf, **(config or {})}
        self.device = resolve_device(device)

    # subclasses provide get_gaussians_properties(camera, model) and bg_color

    def make_settings(self, camera, gaussian_model, device) -> RasterizeSettings:
        return RasterizeSettings(
            image_height=int(camera.image_height),
            image_width=int(camera.image_width),
            tanfovx=camera.tanfovx,
            tanfovy=camera.tanfovy,
            bg=self.bg_color.to(device),
            scale_modifier=self.scaling_modifier,
            viewmatrix=camera.world_view_transform.to(device),
            projmatrix=camera.full_proj_transform.to(device),
            sh_degree=getattr(gaussian_model, "max_sh_degree", 3),
            campos=camera.camera_center.to(device),
            antialias=bool(self.config.get("antialias", False)),
            debug=bool(self.config.get("debug", False)),
        )

    @torch.inference_mode()
    def render(self, viewpoint_camera, gaussian_model):
        """Render one camera; returns the JAX package's output dict."""
        with annotate("gs.render"):
            (xyz, shs, colors_precomp, opacity, scales, rotations, cov3D_precomp) = (
                self.get_gaussians_properties(viewpoint_camera, gaussian_model))
            settings = self.make_settings(viewpoint_camera, gaussian_model, xyz.device)
            active_deg = getattr(gaussian_model, "active_sh_degree", None)
            out = rast.rasterize(
                xyz, opacity, settings, shs=shs, colors_precomp=colors_precomp,
                scales=scales, rotations=rotations, cov3D_precomp=cov3D_precomp,
                active_sh_degree=active_deg if shs is not None else None,
            )
            return {
                "render": out["render"],
                "rendered_depth": out["rendered_depth"],
                "rendered_median_depth": out["rendered_median_depth"],
                "rendered_median_weight": out["rendered_median_weight"],
                "rendered_median_id": out["rendered_median_id"],
                "viewspace_points": torch.zeros((xyz.shape[0], 2), device=xyz.device),
                "visibility_filter": out["radii"] > 0,
                "rendered_final_opacity": out["rendered_final_opacity"],
                "radii": out["radii"],
                "n_contrib": out["n_contrib"],
                "num_rendered": out["num_rendered"],
            }

    def dp_render_closure(self, cameras, gaussian_model):
        """``(settings, render_fn)`` for the camera-parallel renderers
        (parallel/render_dp.make_dp_render_fn / make_dp_fuse_fn).

        The Gaussian properties are computed once, from ``cameras[0]``, which
        holds only where ``view_dependent_gaussians`` is False. All cameras
        must share one resolution and FoV (callers group by (W, H, FoVx,
        FoVy)); ``render_fn(settings)`` returns rasterize()'s outputs."""
        if self.view_dependent_gaussians:
            raise ValueError(f"{type(self).__name__} decodes Gaussians per camera; "
                             "camera-parallel property hoisting is unsupported")
        with torch.inference_mode():
            (xyz, shs, colors_precomp, opacity, scales, rotations, cov3D_precomp) = (
                self.get_gaussians_properties(cameras[0], gaussian_model))
        settings = self.make_settings(cameras[0], gaussian_model, xyz.device)
        active_deg = getattr(gaussian_model, "active_sh_degree", None)

        @torch.inference_mode()
        def render_fn(s):
            return rast.rasterize(
                xyz, opacity, s, shs=shs, colors_precomp=colors_precomp, scales=scales,
                rotations=rotations, cov3D_precomp=cov3D_precomp,
                active_sh_degree=active_deg if shs is not None else None)

        return settings, render_fn
