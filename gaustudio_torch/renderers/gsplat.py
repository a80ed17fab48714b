"""GsplatRenderer — gsplat's antialiased rendering through this package's
rasterizer (port of gaustudio_tpu/renderers/gsplat.py).

It projects with the camera's pixel intrinsics (fx, fy, cx, cy) in place of
the tanfov projection matrix, scales each opacity by gsplat's low-pass
compensation (``antialias``), evaluates SH in Python (+0.5, clamped at 0),
and its alpha map is ``rendered_final_opacity``.
"""

from __future__ import annotations

from gaustudio_torch import renderers
from gaustudio_torch.renderers.vanilla import VanillaRenderer


@renderers.register("gsplat_renderer")
class GsplatRenderer(VanillaRenderer):
    default_conf = {
        "kernel_size": 0.0,
        "scaling_modifier": 1.0,
        "white_background": False,
        "convert_SHs_python": True,
        "compute_cov3D_python": False,
        "antialias": True,
        "debug": False,
    }

    def make_settings(self, camera, gaussian_model, device):
        K = camera.intrinsics.to(device)
        return super().make_settings(camera, gaussian_model, device)._replace(
            intrinsics=K[[0, 1, 0, 1], [0, 1, 2, 2]])
