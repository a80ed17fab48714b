"""ScaffoldRenderer — the per-view neural decode of Scaffold-GS anchors, then
the standard rasterizer (port of gaustudio_tpu/renderers/scaffold.py).

Every anchor decodes its k offset Gaussians; those of anchors behind the
near plane (mark_visible) and those with a non-positive decoded opacity
keep their rows with opacity 0, which the binning culls, as in the JAX
renderer.
"""

from __future__ import annotations

import torch

from gaustudio_torch import renderers
from gaustudio_torch.ops.gaussian import mark_visible
from gaustudio_torch.renderers.base import BaseRenderer


def feature_bank_mix(feat: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """Scaffold-GS's multi-resolution feature: bank [N, 3] weighs the
    feature sampled every 4th, every 2nd and every channel (each sample
    repeated to the full width)."""
    w = feat.shape[1]
    return (torch.repeat_interleave(feat[:, ::4], 4, dim=1)[:, :w] * bank[:, :1]
            + torch.repeat_interleave(feat[:, ::2], 2, dim=1)[:, :w] * bank[:, 1:2]
            + feat * bank[:, 2:])


@renderers.register("scaffold_renderer")
class ScaffoldRenderer(BaseRenderer):
    view_dependent_gaussians = True
    default_conf = {
        "kernel_size": 0.0,
        "scaling_modifier": 1.0,
        "white_background": False,
        "debug": False,
    }

    def __init__(self, config=None, device=None) -> None:
        super().__init__(config, device)
        self.scaling_modifier = self.config["scaling_modifier"]
        self.white_background = self.config["white_background"]
        self.bg_color = (torch.ones(3) if self.white_background else torch.zeros(3)).to(self.device)

    def get_gaussians_properties(self, viewpoint_camera, gaussian_model):
        anchor = gaussian_model.get_attribute("anchor")
        feat = gaussian_model.get_attribute("anchor_feat")
        grid_offsets = gaussian_model.get_attribute("offset")
        grid_scaling = gaussian_model.get_attribute("scale")  # exp-activated [N, 6]
        n, k = anchor.shape[0], gaussian_model.n_offsets
        device = anchor.device

        visible = mark_visible(anchor, viewpoint_camera.world_view_transform.to(device))
        ob_view = anchor - viewpoint_camera.camera_center.to(device)[None, :]
        ob_dist = torch.sqrt(torch.sum(ob_view * ob_view, dim=1, keepdim=True))
        ob_view = ob_view / torch.clamp_min(ob_dist, 1e-9)
        if gaussian_model.use_feat_bank:
            bank = gaussian_model.mlp_feature_bank(torch.cat([ob_view, ob_dist], dim=1))
            feat = feature_bank_mix(feat, bank)
        cat_local = torch.cat([feat, ob_view, ob_dist], dim=1)

        neural_opacity = gaussian_model.mlp_opacity(cat_local).reshape(-1)  # [N*k]
        opacity = torch.where((neural_opacity > 0.0) & torch.repeat_interleave(visible, k),
                              neural_opacity, 0.0)
        color = gaussian_model.mlp_color(cat_local).reshape(n * k, 3)
        scale_rot = gaussian_model.mlp_cov(cat_local).reshape(n * k, 7)

        offsets = grid_offsets.reshape(n * k, 3)
        scaling_rep = torch.repeat_interleave(grid_scaling, k, dim=0)  # [N*k, 6]
        anchor_rep = torch.repeat_interleave(anchor, k, dim=0)
        scales = scaling_rep[:, 3:] * (1.0 / (1.0 + torch.exp(-scale_rot[:, :3])))
        rot = scale_rot[:, 3:7]
        rotations = rot / torch.clamp_min(
            torch.sqrt(torch.sum(rot * rot, dim=-1, keepdim=True)), 1e-9)
        xyz = anchor_rep + offsets * scaling_rep[:, :3]
        return xyz, None, color, opacity, scales, rotations, None
