"""2DGS surfel training (port of gaustudio_tpu/pipelines/train_surfel.py).

The vanilla trainer's state, densification, opacity reset and SH warm-up,
with a step that renders through ops.rasterize_surfel (kernels K1 without
the cull, K2 and K5 forward, K6 backward on a CUDA device) and adds the two
surface regularisers the surfel buffers exist for:

* normal consistency: 1 - <rendered normal, normal of the expected depth
  map>, over the pixels with alpha > 0.5;
* distortion: mean(max(alpha m2 - m1^2, 0)), the per-pixel depth variance
  of the blend from the compositor's sums (sum w d, sum w d^2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from gaustudio_torch.ops import rasterize_surfel
from gaustudio_torch.ops import ssim as ssim_ops
from gaustudio_torch.ops.rasterize import RasterizeSettings
from gaustudio_torch.pipelines.train import (
    CameraBatch,
    TrainConfig,
    Trainer,
    TrainState,
    _features,
    optimise,
)


class SurfelTrainConfig(NamedTuple):
    base: TrainConfig = TrainConfig()
    lambda_normal: float = 0.05
    lambda_dist: float = 0.0  # 2DGS ramps this in after a warm-up


def render_surfels_from_params(params, active_sh_degree: int, settings: RasterizeSettings,
                               means2d_offset=None):
    """Differentiable surfel render of the raw parameters."""
    rot = params["rot"]
    return rasterize_surfel.rasterize_surfels(
        params["xyz"], torch.sigmoid(params["opacity"][:, 0]), settings,
        scales=torch.exp(params["scale"]),
        rotations=rot * torch.rsqrt(torch.sum(rot * rot, dim=-1, keepdim=True) + 1e-18),
        shs=_features(params), means2D_offset=means2d_offset, active_sh_degree=active_sh_degree)


def _unit(x):
    # eps inside the rsqrt: d|x|/dx at x = 0 would poison the gradient
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)


def surfel_loss(out, gt_image, bg, cfg: SurfelTrainConfig):
    """(loss, photo, normal_loss, dist_loss) of a surfel render, with the
    background composited from the rendered alpha."""
    alpha = out["rendered_alpha"][0]
    pred = out["render"] + bg[:, None, None] * (1.0 - alpha)
    photo = ssim_ops.rgb_loss(pred, gt_image, cfg.base.lambda_dssim)

    n_unit = _unit(out["rendered_normal_view"].permute(1, 2, 0))
    depth = out["rendered_depth_sum"][0] / torch.clamp_min(alpha, 1e-6)
    # screen-space normal proxy: the cross of the depth map's central differences
    gx = F.pad(depth[:, 2:] - depth[:, :-2], (1, 1))
    gy = F.pad(depth[2:, :] - depth[:-2, :], (0, 0, 1, 1))
    n_depth = _unit(torch.stack([-gx, -gy, -torch.ones_like(depth)], -1))
    wmask = alpha > 0.5
    normal_loss = torch.where(wmask, 1.0 - torch.sum(n_unit * n_depth, -1), 0.0).sum() / (
        wmask.sum().clamp_min(1).to(torch.float32))

    m1, m2 = out["rendered_dist_m1"][0], out["rendered_dist_m2"][0]
    dist_loss = torch.mean(torch.clamp_min(alpha * m2 - m1 * m1, 0.0))
    loss = photo + cfg.lambda_normal * normal_loss + cfg.lambda_dist * dist_loss
    return loss, photo, normal_loss, dist_loss


def train_step_surfel(state: TrainState, batch: CameraBatch, settings: RasterizeSettings,
                      cfg: SurfelTrainConfig):
    """One 2DGS step: surfel render -> photo + normal + distortion -> Adam ->
    statistics. Returns (new state, metrics)."""
    device = state.params["xyz"].device
    s = settings._replace(viewmatrix=batch.viewmatrix, projmatrix=batch.projmatrix,
                          campos=batch.campos, bg=torch.zeros(3, device=device))
    params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
    offset = torch.zeros((state.num_points, 2), device=device, requires_grad=True)
    out = render_surfels_from_params(params, state.active_sh_degree, s, means2d_offset=offset)
    bg = torch.full((3,), 1.0 if cfg.base.white_background else 0.0, device=device)
    loss, photo, normal_loss, dist_loss = surfel_loss(out, batch.gt_image, bg, cfg)
    metrics = {
        "loss": loss.detach(), "photo": photo.detach(), "normal_loss": normal_loss.detach(),
        "dist_loss": dist_loss.detach(),
        "psnr": ssim_ops.psnr(out["render"].detach(), batch.gt_image),
        "num_points": state.num_points, "num_rendered": out["num_rendered"],
    }
    return optimise(state, params, offset, loss, out["radii"], cfg.base), metrics


class SurfelTrainer(Trainer):
    """The vanilla training loop with 2-column scales and the surfel step."""

    def __init__(self, pcd, dataset, cfg: SurfelTrainConfig = SurfelTrainConfig(), seed: int = 0,
                 device=None):
        super().__init__(pcd, dataset, cfg.base, seed=seed, device=device)
        self.surfel_cfg = cfg

    def step(self, batch: CameraBatch, settings: RasterizeSettings):
        return train_step_surfel(self.state, batch, settings, self.surfel_cfg)
