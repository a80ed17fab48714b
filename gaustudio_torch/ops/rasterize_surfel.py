"""2DGS surfel rasterization (port of gaustudio_tpu/ops/rasterize_surfel.py).

Each splat is a 2D Gaussian disk in its tangent plane; a pixel's camera ray
is intersected with that plane by the two-plane (hu, hv) construction of the
2DGS paper, with the 2D screen-space low-pass as fallback, as the JAX
package does.

preprocess_surfel (torch ops under autograd) -> binning (kernels K1 without
the tile cull and K2, and a stable torch.sort, on detached values) ->
compositing (kernel K5 forward, kernel K6 backward, in
composite_surfel.composite_surfel). CUDA tensors go through the kernels and
CPU tensors through their plain versions; ``backend="plain"`` asks for the
plain versions on any device.

Outputs (CHW), the JAX package's keys: render [3,H,W], rendered_alpha
[1,H,W], rendered_normal_view [3,H,W], rendered_depth_sum [1,H,W] (divide by
alpha outside), rendered_median_depth / _weight [1,H,W], rendered_median_id
[1,H,W] int32, rendered_dist_m1 (the depth sum itself: one output, so the
cotangents of the two keys add) and rendered_dist_m2 [1,H,W], radii [N]
int32, n_contrib [H,W] int32, num_rendered.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaustudio_torch.ops import binning, composite_surfel
from gaustudio_torch.ops import sh as sh_ops
from gaustudio_torch.ops.gaussian import (
    NEAR_CULL_Z,
    TILE_X,
    TILE_Y,
    Preprocessed,
    get_rect,
    quat_to_rotmat,
    transform_dirs,
    transform_points,
)
from gaustudio_torch.ops.rasterize import BACKENDS
from gaustudio_torch.utils.observability import annotate


class SurfelPre(NamedTuple):
    valid: torch.Tensor  # [N] bool
    depths: torch.Tensor  # [N] centre view depth
    mean2d: torch.Tensor  # [N, 2] projected centre (pixels)
    M: torch.Tensor  # [N, 3, 3] rows (Mx, My, Mw): (u, v, 1) -> pixel homogeneous
    Dk: torch.Tensor  # [N, 3] view-depth coefficients over (u, v, 1)
    normal_view: torch.Tensor  # [N, 3] splat normal in view space
    opacities: torch.Tensor  # [N]
    colors: torch.Tensor  # [N, 3]
    radii: torch.Tensor  # [N] int32
    rect_min: torch.Tensor  # [N, 2] int32
    rect_max: torch.Tensor  # [N, 2] int32, exclusive
    tiles_touched: torch.Tensor  # [N] int32


def preprocess_surfel(means3d, opacities, viewmatrix, projmatrix, campos, image_width: int,
                      image_height: int, *, scales, rotations, shs=None, sh_degree: int = 3,
                      colors_precomp=None, scale_modifier: float = 1.0,
                      means2d_offset=None) -> SurfelPre:
    """Per-splat set-up: tangent frame -> pixel-space homography, in the JAX
    package's operation order."""
    W, H = image_width, image_height
    grid_x = (W + TILE_X - 1) // TILE_X
    grid_y = (H + TILE_Y - 1) // TILE_Y

    R = quat_to_rotmat(rotations, normalize=True)
    # the columns of R are the rotated axes: t_u = R[:, :, 0] su, ...
    su = scales[:, 0] * scale_modifier
    sv = scales[:, 1] * scale_modifier
    tu = R[..., :, 0] * su[:, None]
    tv = R[..., :, 1] * sv[:, None]
    nrm = R[..., :, 2]

    depths = transform_points(means3d, viewmatrix)[..., 2]
    in_front = depths > NEAR_CULL_Z

    # images of (u, v, 1) under the full projective transform
    Su = transform_dirs(tu, projmatrix)
    Sv = transform_dirs(tv, projmatrix)
    Sp = transform_points(means3d, projmatrix)

    def pix_rows(S):
        # px w = 0.5 W (x + w) - 0.5 w ; py w = 0.5 H (y + w) - 0.5 w
        mx = 0.5 * W * (S[..., 0] + S[..., 3]) - 0.5 * S[..., 3]
        my = 0.5 * H * (S[..., 1] + S[..., 3]) - 0.5 * S[..., 3]
        return mx, my, S[..., 3]

    mxu, myu, mwu = pix_rows(Su)
    mxv, myv, mwv = pix_rows(Sv)
    mxp, myp, mwp = pix_rows(Sp)
    M = torch.stack([torch.stack([mxu, mxv, mxp], -1), torch.stack([myu, myv, myp], -1),
                     torch.stack([mwu, mwv, mwp], -1)], dim=-2)

    Rv = viewmatrix[:3, :3]
    Dk = torch.stack([transform_dirs(tu, Rv)[..., 2], transform_dirs(tv, Rv)[..., 2], depths], -1)
    normal_view = transform_dirs(nrm, Rv)

    w_c = mwp + 1e-7
    mean2d = torch.stack([mxp / w_c, myp / w_c], -1)
    if means2d_offset is not None:
        mean2d = mean2d + means2d_offset

    with torch.no_grad():  # the screen radius feeds only the integer rect
        cx, cy = mean2d[..., 0], mean2d[..., 1]

        def axis_extent(mx, my, mw):  # |projected axis endpoint - centre|
            ex = (mxp + mx) / (w_c + mw) - cx
            ey = (myp + my) / (w_c + mw) - cy
            return torch.sqrt(ex * ex + ey * ey)

        radius = torch.ceil(3.0 * torch.clamp_min(
            torch.maximum(axis_extent(mxu, myu, mwu), axis_extent(mxv, myv, mwv)), 2.0))
        rect_min, rect_max = get_rect(mean2d, radius, grid_x, grid_y)
        rect_wh = rect_max - rect_min
        tiles = rect_wh[..., 0] * rect_wh[..., 1]
        valid = in_front & (tiles > 0) & torch.isfinite(radius)

    if colors_precomp is not None:
        colors = colors_precomp
    else:
        max_deg = min(sh_ops.RASTER_MAX_DEGREE, int(round(shs.shape[1] ** 0.5)) - 1)
        colors, _ = sh_ops.sh_to_rgb_clamped(sh_degree, shs, means3d, campos, max_deg)

    zero = torch.zeros((), dtype=torch.int32, device=means3d.device)
    return SurfelPre(
        valid=valid, depths=depths, mean2d=mean2d, M=M, Dk=Dk, normal_view=normal_view,
        opacities=torch.reshape(opacities, (-1,)), colors=colors,
        radii=torch.where(valid, radius.to(torch.int32), zero),
        rect_min=rect_min, rect_max=rect_max,
        tiles_touched=torch.where(valid, tiles, zero))


def binning_input(pre: SurfelPre) -> Preprocessed:
    """The detached binning input of a surfel preprocess: surfels have no
    conic, so K1 runs without the tile cull and never reads it."""
    return Preprocessed(
        valid=pre.valid, depths=pre.depths.detach(), means2d=pre.mean2d.detach(),
        conic=pre.depths.new_zeros((pre.depths.shape[0], 3)), opacities=pre.opacities.detach(),
        colors=pre.colors.detach(), radii=pre.radii, rect_min=pre.rect_min,
        rect_max=pre.rect_max, tiles_touched=pre.tiles_touched)


def rasterize_surfels(means3D, opacities, settings, *, scales, rotations, shs=None,
                      colors_precomp=None, means2D_offset=None, active_sh_degree=None):
    """Differentiable 2DGS rasterization returning the surfel buffer dict.

    ``settings`` is an ops.rasterize.RasterizeSettings; its ``bg`` is not
    used (the background is composited by the caller, from rendered_alpha).
    ``means2D_offset`` [N, 2] receives the pixel-space centre gradient scaled
    by (0.5 W, 0.5 H), the viewspace gradient that densification reads.
    """
    if (shs is None) == (colors_precomp is None):
        raise ValueError("Please provide exactly one of SHs or precomputed colors")
    if settings.backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {settings.backend!r}")
    H, W = settings.image_height, settings.image_width
    grid_x = (W + TILE_X - 1) // TILE_X
    grid_y = (H + TILE_Y - 1) // TILE_Y

    pix_offset = None
    if means2D_offset is not None:
        pix_offset = means2D_offset * torch.tensor(
            [0.5 * W, 0.5 * H], dtype=means2D_offset.dtype, device=means2D_offset.device)

    with annotate("gs.preprocess", means3D):
        pre = preprocess_surfel(
            means3D, opacities, settings.viewmatrix, settings.projmatrix, settings.campos, W, H,
            scales=scales, rotations=rotations, shs=shs,
            sh_degree=settings.sh_degree if active_sh_degree is None else active_sh_degree,
            colors_precomp=colors_precomp, scale_modifier=settings.scale_modifier,
            means2d_offset=pix_offset)

    plain = settings.backend == "plain"
    binned = binning.bin_gaussians(binning_input(pre), grid_x, grid_y, plain=plain, cull=False)
    with annotate("gs.composite", means3D):
        out = composite_surfel.composite_surfel(
            pre.M, pre.Dk, pre.mean2d, pre.opacities, pre.colors, pre.normal_view, binned.ranges,
            binned.point_list, grid_x, grid_y, W, H, plain=plain)
    return {
        "render": out.color,
        "rendered_alpha": (1.0 - out.final_T)[None],
        "rendered_normal_view": out.normal,
        "rendered_depth_sum": out.depth_sum,
        "rendered_median_depth": out.median_depth,
        "rendered_median_weight": out.median_weight,
        "rendered_median_id": out.median_id,
        "rendered_dist_m1": out.depth_sum,
        "rendered_dist_m2": out.dist_m2,
        "radii": pre.radii,
        "n_contrib": out.n_contrib,
        "num_rendered": binned.num_rendered,
    }
