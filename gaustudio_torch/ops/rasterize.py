"""Forward rasterization API (port of gaustudio_tpu/ops/rasterize.py).

preprocess (torch ops) -> binning (kernels K1, K2 and a stable torch.sort)
-> compositing (kernel K3). CUDA tensors go through the kernels and CPU
tensors through their plain versions; ``backend="plain"`` asks for the
plain versions on any device.

Outputs (CHW): render [3,H,W], rendered_depth [1,H,W],
rendered_median_depth [1,H,W], rendered_median_weight [1,H,W],
rendered_median_id [1,H,W] int32, rendered_final_opacity [1,H,W],
radii [N] int32, n_contrib [H,W] int32, num_rendered (entries after the
tile cull).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaustudio_torch.ops import binning, composite, gaussian

BACKENDS = ("auto", "plain")


class RasterizeSettings(NamedTuple):
    image_height: int
    image_width: int
    tanfovx: float
    tanfovy: float
    bg: torch.Tensor  # [3]; not composited in the forward
    scale_modifier: float = 1.0
    viewmatrix: torch.Tensor = None  # [4,4] transposed W2V
    projmatrix: torch.Tensor = None  # [4,4] transposed W2V @ P
    sh_degree: int = 3
    campos: torch.Tensor = None  # [3]
    backend: str = "auto"  # "auto": kernels on CUDA; "plain": plain versions
    antialias: bool = False  # gsplat slice
    intrinsics: Optional[torch.Tensor] = None  # gsplat slice


def rasterize(means3D, opacities, settings: RasterizeSettings, *, shs=None,
              colors_precomp=None, scales=None, rotations=None, cov3D_precomp=None,
              active_sh_degree=None):
    """Forward 3DGS rasterization.

    Exactly one of (shs, colors_precomp) and exactly one of
    (scales + rotations, cov3D_precomp) must be given.
    """
    if (shs is None) == (colors_precomp is None):
        raise ValueError("Please provide exactly one of SHs or precomputed colors")
    if ((scales is None or rotations is None) and cov3D_precomp is None) or (
        scales is not None and cov3D_precomp is not None
    ):
        raise ValueError(
            "Please provide exactly one of scales/rotations or precomputed 3D covariance")
    if settings.backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {settings.backend!r}")

    H, W = settings.image_height, settings.image_width
    grid_x = (W + gaussian.TILE_X - 1) // gaussian.TILE_X
    grid_y = (H + gaussian.TILE_Y - 1) // gaussian.TILE_Y

    pre = gaussian.preprocess(
        means3D, torch.reshape(opacities, (-1,)), settings.viewmatrix,
        settings.projmatrix, settings.campos, W, H, settings.tanfovx,
        settings.tanfovy, antialias=settings.antialias, shs=shs,
        sh_degree=settings.sh_degree if active_sh_degree is None else active_sh_degree,
        colors_precomp=colors_precomp, scales=scales, rotations=rotations,
        cov3d_precomp=cov3D_precomp, scale_modifier=settings.scale_modifier,
        intrinsics=settings.intrinsics,
    )

    plain = settings.backend == "plain"
    binned = binning.bin_gaussians(pre, grid_x, grid_y, plain=plain)
    render_fn = composite.render_tiles_plain if plain else composite.render_tiles
    out = render_fn(binned.ranges, binned.point_list, pre.means2d, pre.conic,
                    pre.opacities, pre.colors, pre.depths, grid_x, grid_y, W, H)
    return {
        "render": out.color,
        "rendered_depth": out.depth,
        "rendered_median_depth": out.median_depth,
        "rendered_median_weight": out.median_weight,
        "rendered_median_id": out.median_id,
        "rendered_final_opacity": (1.0 - out.final_T)[None],
        "radii": pre.radii,
        "n_contrib": out.n_contrib,
        "num_rendered": binned.num_rendered,
    }


def mark_visible(positions, viewmatrix, projmatrix):
    """View-space z > 0.2 frustum check."""
    return gaussian.mark_visible(positions, viewmatrix, projmatrix)
