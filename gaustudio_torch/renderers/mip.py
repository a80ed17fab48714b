"""MipRenderer — Mip-Splatting rendering with the 3D smoothing filter (port
of gaustudio_tpu/renderers/mip.py).

Where the model has no filter yet, it is computed from the first camera
rendered and kept for every later view, as the JAX renderer does.
``kernel_size`` rides in the config and nothing reads it, as there.
"""

from __future__ import annotations

from gaustudio_torch import renderers
from gaustudio_torch.renderers.vanilla import VanillaRenderer


@renderers.register("mip_renderer")
class MipRenderer(VanillaRenderer):
    default_conf = {
        "kernel_size": 0.3,
        "scaling_modifier": 1.0,
        "white_background": False,
        "convert_SHs_python": False,
        "compute_cov3D_python": False,
        "debug": False,
    }

    def get_gaussians_properties(self, viewpoint_camera, gaussian_model):
        """The vanilla properties with the filtered opacity and scaling."""
        if getattr(gaussian_model, "filter_3D", None) is None:
            gaussian_model.compute_3D_filter([viewpoint_camera])
        xyz, shs, colors_precomp, _, scales, rotations, cov3D_precomp = (
            super().get_gaussians_properties(viewpoint_camera, gaussian_model))
        if scales is not None:
            scales = gaussian_model.get_scaling_with_3D_filter
        return (xyz, shs, colors_precomp, gaussian_model.get_opacity_with_3D_filter, scales,
                rotations, cov3D_precomp)
