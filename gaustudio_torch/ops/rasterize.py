"""Differentiable rasterization API (port of gaustudio_tpu/ops/rasterize.py).

preprocess (torch ops under autograd) -> binning (kernels K1, K2 and a
stable torch.sort, on detached values) -> compositing (kernel K3 forward,
kernel K4 backward, in composite.composite). CUDA tensors go through the
kernels and CPU tensors through their plain versions; ``backend="plain"``
asks for the plain versions on any device.

Outputs (CHW): render [3,H,W], rendered_depth [1,H,W],
rendered_median_depth [1,H,W], rendered_median_weight [1,H,W],
rendered_median_id [1,H,W] int32, rendered_final_opacity [1,H,W],
radii [N] int32, n_contrib [H,W] int32, num_rendered (entries after the
tile cull).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from gaustudio_torch.ops import binning, composite, gaussian
from gaustudio_torch.utils.observability import annotate, count

BACKENDS = ("auto", "plain")


class RasterizeSettings(NamedTuple):
    image_height: int
    image_width: int
    tanfovx: float
    tanfovy: float
    bg: torch.Tensor  # [3]; not composited in the forward, used in the backward
    scale_modifier: float = 1.0
    viewmatrix: torch.Tensor = None  # [4,4] transposed W2V
    projmatrix: torch.Tensor = None  # [4,4] transposed W2V @ P
    sh_degree: int = 3
    campos: torch.Tensor = None  # [3]
    backend: str = "auto"  # "auto": kernels on CUDA; "plain": plain versions
    antialias: bool = False  # gsplat slice
    intrinsics: Optional[torch.Tensor] = None  # gsplat slice
    debug: bool = False  # snapshot inputs and outputs when any is non-finite


def rasterize(means3D, opacities, settings: RasterizeSettings, *, shs=None,
              colors_precomp=None, scales=None, rotations=None, cov3D_precomp=None,
              means2D_offset=None, active_sh_degree=None):
    """Differentiable 3DGS rasterization.

    Exactly one of (shs, colors_precomp) and exactly one of
    (scales + rotations, cov3D_precomp) must be given. ``means2D_offset``
    [N, 2] stands for the reference's zero ``screenspace_points`` input: its
    gradient is the pixel-space mean gradient scaled by (0.5 W, 0.5 H), the
    reference's viewspace gradient convention that densification reads.
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

    pix_offset = None
    if means2D_offset is not None:
        pix_offset = means2D_offset * torch.tensor(
            [0.5 * W, 0.5 * H], dtype=means2D_offset.dtype, device=means2D_offset.device)

    with annotate("gs.preprocess", means3D):
        pre = gaussian.preprocess(
            means3D, torch.reshape(opacities, (-1,)), settings.viewmatrix,
            settings.projmatrix, settings.campos, W, H, settings.tanfovx,
            settings.tanfovy, antialias=settings.antialias, shs=shs,
            sh_degree=settings.sh_degree if active_sh_degree is None else active_sh_degree,
            colors_precomp=colors_precomp, scales=scales, rotations=rotations,
            cov3d_precomp=cov3D_precomp, scale_modifier=settings.scale_modifier,
            means2d_offset=pix_offset, intrinsics=settings.intrinsics,
        )
    count("gs.frustum", pre.valid)
    count("gs.pixels", W * H)

    plain = settings.backend == "plain"
    binned = binning.bin_gaussians(gaussian.Preprocessed(*(x.detach() for x in pre)),
                                   grid_x, grid_y, plain=plain)
    bg = settings.bg if settings.bg is not None else torch.zeros(3)
    with annotate("gs.composite", means3D):
        out = composite.composite(pre.means2d, pre.conic, pre.opacities, pre.colors,
                                  pre.depths, bg.to(device=pre.depths.device, dtype=torch.float32),
                                  binned.ranges, binned.point_list, grid_x, grid_y, W, H,
                                  plain=plain)
    if settings.debug:
        # the reference's debug=True dumps the kernel arguments for offline
        # repro (gaustudio_diff_gaussian_rasterization/__init__.py:83-90);
        # here, as in the JAX package, inputs and outputs are saved to
        # $GS_DEBUG_SNAPSHOT whenever any of them is non-finite
        from gaustudio_torch.utils import observability

        observability.snapshot_on_nonfinite(
            {"inputs": {"means3D": means3D, "opacities": torch.reshape(opacities, (-1,)),
                        "shs": shs, "colors_precomp": colors_precomp, "scales": scales,
                        "rotations": rotations, "cov3D_precomp": cov3D_precomp,
                        "viewmatrix": settings.viewmatrix, "projmatrix": settings.projmatrix},
             "outputs": {"render": out.color, "depth": out.depth, "final_T": out.final_T}},
            os.environ.get("GS_DEBUG_SNAPSHOT", "snapshot_fw.dump"),
            context="rasterize forward (debug=True)")
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
