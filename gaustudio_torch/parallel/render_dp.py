"""Camera-parallel rendering and multi-view TSDF fusion (port of
gaustudio_tpu/parallel/render_dp.py) on torch.distributed.

The views of a ``RenderCamera`` stack are split over the dp axis in blocks,
as ``P("dp")`` splits the JAX stack: dp rank r renders views
[r B / dp, (r + 1) B / dp). The gs ranks of one dp index render the same
block. Fusion integrates each rank's views into a private volume and merges
the volumes with a sum over dp.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaustudio_torch.ops import tsdf
from gaustudio_torch.ops.rasterize import RasterizeSettings
from gaustudio_torch.parallel.mesh import Collectives, collectives


class RenderCamera(NamedTuple):
    """Stacked per-view tensors (leading axis = number of views)."""

    viewmatrix: torch.Tensor  # [B, 4, 4]
    projmatrix: torch.Tensor  # [B, 4, 4]
    campos: torch.Tensor  # [B, 3]
    intrinsics: torch.Tensor  # [B, 3, 3]
    world_to_cam: torch.Tensor  # [B, 4, 4]
    valid: Optional[torch.Tensor] = None  # [B] 1.0 real view / 0.0 pad


def stack_cameras(cameras, pad_to: int = 0, device=None) -> RenderCamera:
    """Stack Camera objects into a RenderCamera on ``device`` (None: the
    first camera's), padding to a multiple of ``pad_to`` with valid=0
    repeats of the first view (a pad view renders normally but its depth is
    zeroed before TSDF integration, so it contributes nothing)."""
    n = len(cameras)
    total = n if pad_to <= 0 else -(-n // pad_to) * pad_to
    idx = list(range(n)) + [0] * (total - n)
    device = device if device is not None else cameras[0].world_view_transform.device
    stack = lambda attr: torch.stack(  # noqa: E731
        [getattr(cameras[i], attr).to(device, torch.float32) for i in idx])
    return RenderCamera(
        viewmatrix=stack("world_view_transform"), projmatrix=stack("full_proj_transform"),
        campos=stack("camera_center"), intrinsics=stack("intrinsics"),
        world_to_cam=stack("extrinsics"),
        valid=torch.tensor([1.0] * n + [0.0] * (total - n), device=device))


def local_block(comm: Collectives, cams: RenderCamera) -> RenderCamera:
    """This dp rank's block of the stacked views."""
    b = cams.viewmatrix.shape[0]
    if b % comm.dp:
        raise ValueError(f"{b} views do not split over dp={comm.dp}: stack_cameras(pad_to=dp)")
    per = b // comm.dp
    lo = comm.dp_rank * per
    return RenderCamera(*[None if x is None else x[lo:lo + per] for x in cams])


def _view_settings(settings: RasterizeSettings, cams: RenderCamera, i: int) -> RasterizeSettings:
    return settings._replace(viewmatrix=cams.viewmatrix[i], projmatrix=cams.projmatrix[i],
                             campos=cams.campos[i])


def make_dp_render_fn(mesh, settings: RasterizeSettings, render_fn):
    """Batch-render views over the dp axis.

    ``render_fn(settings) -> dict`` is a closure over the Gaussians (a
    renderer's ``dp_render_closure``). The returned function takes the whole
    stack and returns this rank's block: only ``render`` and the
    ``rendered_*`` buffers, each stacked over the block's views (per-Gaussian
    outputs such as radii have no consumer, as in the JAX package)."""
    comm = collectives(mesh)

    @torch.inference_mode()
    def render(cams: RenderCamera):
        local = local_block(comm, cams)
        outs = []
        for i in range(local.viewmatrix.shape[0]):
            out = render_fn(_view_settings(settings, local, i))
            outs.append({k: v for k, v in out.items()
                         if k == "render" or k.startswith("rendered_")})
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    render.comm = comm
    return render


def masked_depth(out: dict, valid=None) -> torch.Tensor:
    """The median depth of one view's render, zeroed where its final
    opacity is below 0.5 and everywhere for a pad view."""
    depth = torch.where(out["rendered_final_opacity"][0] < 0.5, 0.0,
                        out["rendered_median_depth"][0])
    return depth if valid is None else depth * valid


def make_dp_fuse_fn(mesh, settings: RasterizeSettings, render_fn):
    """Render and TSDF-integrate a stack of views, summing the volumes over dp.

    Returns fuse(volume, cams) -> the merged volume: each rank integrates
    its block into a private volume (tsdf 1, weight 0), then
    num = sum_dp(tsdf w) + the carried tsdf w, den = sum_dp(w) + the carried
    w, and tsdf = num / max(den, 1e-9) where den > 0. As in the JAX package
    the merged weight is not capped at ``integrate``'s 64."""
    comm = collectives(mesh)

    @torch.no_grad()
    def fuse(volume: tsdf.TSDFVolume, cams: RenderCamera) -> tsdf.TSDFVolume:
        local_cams = local_block(comm, cams)
        local = tsdf.TSDFVolume(torch.ones_like(volume.tsdf), torch.zeros_like(volume.weight),
                                volume.origin, volume.voxel_size, volume.sdf_trunc)
        for i in range(local_cams.viewmatrix.shape[0]):
            out = render_fn(_view_settings(settings, local_cams, i))
            valid = None if local_cams.valid is None else local_cams.valid[i]
            tsdf.integrate(local, masked_depth(out, valid), local_cams.intrinsics[i],
                           local_cams.world_to_cam[i])
        num = comm.sum_dp(local.tsdf * local.weight) + volume.tsdf * volume.weight
        den = comm.sum_dp(local.weight) + volume.weight
        merged = torch.where(den > 0, num / torch.clamp_min(den, 1e-9), 1.0)
        return tsdf.TSDFVolume(merged, den, volume.origin, volume.voxel_size, volume.sdf_trunc)

    fuse.comm = comm
    return fuse
