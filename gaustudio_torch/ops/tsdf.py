"""TSDF fusion: projective truncated-signed-distance integration on a dense
voxel grid (port of gaustudio_tpu/ops/tsdf.py).

Every voxel centre is projected into a depth map, the view-ray SDF is clamped
to the truncation band, and (tsdf, weight) are updated as a running weighted
average, in the JAX package's order of operations. The grid lives on the
volume's device: the current CUDA device unless the caller names one.
``integrate`` works an x-slab of the grid at a time, so its float
intermediates stay near ``SLAB_VOXELS`` voxels whatever the grid's size; the
grid's bounds and dims are computed on the host in float64.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from gaustudio_torch.utils.misc import resolve_device

SLAB_VOXELS = 1 << 23  # voxels a slab of integrate: ~32 MiB a float intermediate


@dataclasses.dataclass
class TSDFVolume:
    """Dense TSDF grid state."""

    tsdf: torch.Tensor  # [X, Y, Z] in [-1, 1]
    weight: torch.Tensor  # [X, Y, Z]
    origin: torch.Tensor  # [3] world position of the centre of voxel (0, 0, 0)
    voxel_size: torch.Tensor  # [] float32
    sdf_trunc: torch.Tensor  # [] float32

    @classmethod
    def from_numpy(cls, tsdf, weight, origin, voxel_size, sdf_trunc, device=None) -> "TSDFVolume":
        """A volume from host arrays (those of a JAX package volume, say) on
        ``device`` (None: the current CUDA device)."""
        device = resolve_device(device)
        f32 = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)  # noqa: E731
        return cls(f32(tsdf), f32(weight), f32(origin), f32(voxel_size), f32(sdf_trunc))


def create_volume(origin, dims: Tuple[int, int, int], voxel_size: float, sdf_trunc: float,
                  device=None) -> TSDFVolume:
    device = resolve_device(device)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return TSDFVolume(
        tsdf=torch.ones(dims, dtype=torch.float32, device=device),
        weight=torch.zeros(dims, dtype=torch.float32, device=device),
        origin=f32(origin), voxel_size=f32(voxel_size), sdf_trunc=f32(sdf_trunc))


def volume_from_bounds(lo, hi, voxel_size: float, sdf_trunc: float, max_dim: int = 512,
                       device=None) -> TSDFVolume:
    """A grid covering [lo, hi] with at most max_dim voxels along its longest
    side: a larger extent coarsens the voxel and the truncation alike."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    extent = float(np.max(hi - lo))
    if extent / voxel_size + 1 > max_dim:
        scale = (extent / (max_dim - 1)) / voxel_size
        voxel_size = voxel_size * scale
        sdf_trunc = sdf_trunc * scale
    dims = np.ceil((hi - lo) / voxel_size).astype(int) + 1
    return create_volume(lo, tuple(int(d) for d in dims), voxel_size, sdf_trunc, device)


def integrate(volume: TSDFVolume, depth, intrinsics, world_to_cam,
              max_weight: float = 64.0) -> TSDFVolume:
    """Fuse one depth map into ``volume``, in place; returns the volume.

    Args:
        depth: [H, W] metric depth along the camera z axis; <= 0 marks
            invalid pixels.
        intrinsics: [3, 3] pinhole K (pixel units).
        world_to_cam: [4, 4] world -> view matrix in math convention
            (``Camera.extrinsics``).
    """
    device = volume.tsdf.device
    depth, K, E = (_f32(a, device) for a in (depth, intrinsics, world_to_cam))
    H, W = depth.shape
    X, Y, Z = volume.tsdf.shape
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    trunc = volume.sdf_trunc
    # voxel centres by axis: origin + index * voxel, as the JAX package
    # computes them per voxel
    axes = [volume.origin[a] + torch.arange(n, device=device, dtype=torch.float32)
            * volume.voxel_size for a, n in enumerate((X, Y, Z))]
    wy, wz = axes[1][None, :, None], axes[2][None, None, :]
    rows = max(1, SLAB_VOXELS // (Y * Z))
    for x0 in range(0, X, rows):
        wx = axes[0][x0:x0 + rows, None, None]
        # world @ R^T + t, one component at a time (no TF32 matmul)
        cam = [wx * E[i, 0] + wy * E[i, 1] + wz * E[i, 2] + E[i, 3] for i in range(3)]
        z = cam[2]
        u = cam[0] / z * fx + cx
        v = cam[1] / z * fy + cy
        # round half to even, as jnp.round; to int32 before the clamp, as the JAX code
        ui = torch.clamp(torch.round(u).to(torch.int32), 0, W - 1)
        vi = torch.clamp(torch.round(v).to(torch.int32), 0, H - 1)
        in_img = (z > 1e-4) & (u >= -0.5) & (u <= W - 0.5) & (v >= -0.5) & (v <= H - 0.5)
        del u, v, cam
        d = depth[vi.long(), ui.long()]
        del ui, vi
        sdf = d - z
        update = in_img & (d > 0.0) & (sdf > -trunc)
        tsdf_obs = torch.clamp_max(sdf / trunc, 1.0)
        del d, z, sdf, in_img
        tsdf_old = volume.tsdf[x0:x0 + rows]
        w_old = volume.weight[x0:x0 + rows]
        w_obs = update.float()
        w_new = w_old + w_obs
        tsdf_new = torch.where(
            update, (tsdf_old * w_old + tsdf_obs * w_obs) / torch.clamp_min(w_new, 1e-9),
            tsdf_old)
        tsdf_old.copy_(tsdf_new)
        w_old.copy_(torch.clamp_max(w_new, max_weight))
    return volume


def integrate_batch(volume: TSDFVolume, depths, intrinsics, world_to_cam) -> TSDFVolume:
    """Fuse a stack of views ([B, H, W] depths, [B, 3, 3], [B, 4, 4]) one
    after the other with :func:`integrate`, in place; returns the volume."""
    for depth, K, E in zip(depths, intrinsics, world_to_cam):
        integrate(volume, depth, K, E)
    return volume


def _f32(a, device) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, np.float32))
    return a.to(device=device, dtype=torch.float32)


def integrate_points_bounds(points) -> Tuple[np.ndarray, np.ndarray]:
    """Robust bounds of a point set on the host: the 2nd and 98th
    percentiles of its finite points, padded by 5% of their spread."""
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    pts = np.asarray(points)
    finite = np.isfinite(pts).all(axis=1)
    if not finite.all():
        if not finite.any():
            raise ValueError("integrate_points_bounds: no finite points")
        pts = pts[finite]
    lo = np.percentile(pts, 2, axis=0)
    hi = np.percentile(pts, 98, axis=0)
    pad = 0.05 * (hi - lo + 1e-6)
    return lo - pad, hi + pad
