"""Per-Gaussian projection math — the rasterizer's preprocess stage.

Port of gaustudio_tpu/ops/gaussian.py in plain torch ops: frustum culling,
3D covariance from scale/quaternion, EWA 2D covariance with the fov clamp
and the 0.3 low-pass, conic, screen radius and the tight tile rect (the
3-sigma circle intersected with the opacity support ellipse). The JAX
package has no Pallas kernel here, so neither does the port. Expressions
keep the JAX package's operation order so both give the same float32
results.

``viewmatrix`` / ``projmatrix`` are the transposed W2V / W2V @ P matrices
(row-vector convention, ``p_view = (p, 1) @ viewmatrix``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaustudio_torch.ops import sh as sh_ops

TILE_X = 16
TILE_Y = 16
TILE_PIXELS = TILE_X * TILE_Y

# Frustum near-cull threshold (view-space z).
NEAR_CULL_Z = 0.2


def quat_to_rotmat(q: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> rotation matrix [..., 3, 3]."""
    if normalize:
        q = q * torch.rsqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-18)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z), 2.0 * (x * z + r * y)], -1)
    row1 = torch.stack(
        [2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - r * x)], -1)
    row2 = torch.stack(
        [2.0 * (x * z - r * y), 2.0 * (y * z + r * x), 1.0 - 2.0 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def build_cov3d(scale, scale_modifier, quat):
    """Sigma = R S^2 R^T as (xx, xy, xz, yy, yz, zz); the quaternion is not
    normalised, like the CUDA reference's computeCov3D."""
    r, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    R00 = 1.0 - 2.0 * (y * y + z * z)
    R01 = 2.0 * (x * y - r * z)
    R02 = 2.0 * (x * z + r * y)
    R10 = 2.0 * (x * y + r * z)
    R11 = 1.0 - 2.0 * (x * x + z * z)
    R12 = 2.0 * (y * z - r * x)
    R20 = 2.0 * (x * z - r * y)
    R21 = 2.0 * (y * z + r * x)
    R22 = 1.0 - 2.0 * (x * x + y * y)
    s0 = (scale_modifier * scale[..., 0]) ** 2
    s1 = (scale_modifier * scale[..., 1]) ** 2
    s2 = (scale_modifier * scale[..., 2]) ** 2
    c_xx = R00 * R00 * s0 + R01 * R01 * s1 + R02 * R02 * s2
    c_xy = R00 * R10 * s0 + R01 * R11 * s1 + R02 * R12 * s2
    c_xz = R00 * R20 * s0 + R01 * R21 * s1 + R02 * R22 * s2
    c_yy = R10 * R10 * s0 + R11 * R11 * s1 + R12 * R12 * s2
    c_yz = R10 * R20 * s0 + R11 * R21 * s1 + R12 * R22 * s2
    c_zz = R20 * R20 * s0 + R21 * R21 * s1 + R22 * R22 * s2
    return torch.stack([c_xx, c_xy, c_xz, c_yy, c_yz, c_zz], dim=-1)


def transform_points(points, mat4):
    """(p, 1) @ mat4 -> [..., 4], written out per component."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return torch.stack(
        [x * mat4[0, i] + y * mat4[1, i] + z * mat4[2, i] + mat4[3, i] for i in range(4)],
        dim=-1,
    )


def transform_dirs(dirs, mat):
    """dirs @ mat for [..., 3] x [3, C] (no translation row), written out per
    component."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    return torch.stack(
        [x * mat[0, i] + y * mat[1, i] + z * mat[2, i] for i in range(mat.shape[1])], dim=-1)


def _signed_clamp(v, floor):
    """Keep |v| >= floor with v's sign, so 1/v stays finite on culled rows."""
    return torch.where(v >= 0.0, torch.clamp_min(v, floor), torch.clamp_max(v, -floor))


def compute_cov2d(means3d, focal_x, focal_y, tan_fovx, tan_fovy, cov3d, viewmatrix):
    """EWA projection: J W Sigma W^T J^T + 0.3 I -> [..., 3] (xx, xy, yy)."""
    t = transform_points(means3d, viewmatrix)[..., :3]
    tz = _signed_clamp(t[..., 2], NEAR_CULL_Z)
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    txtz = t[..., 0] / tz
    tytz = t[..., 1] / tz
    tx = torch.clamp(txtz, -limx, limx) * tz
    ty = torch.clamp(tytz, -limy, limy) * tz

    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    j00 = focal_x * inv_tz
    j02 = -focal_x * tx * inv_tz2
    j11 = focal_y * inv_tz
    j12 = -focal_y * ty * inv_tz2

    Rwv = viewmatrix[:3, :3].T  # world -> view rotation
    c0, c1, c2 = cov3d[..., 0], cov3d[..., 1], cov3d[..., 2]
    c3, c4, c5 = cov3d[..., 3], cov3d[..., 4], cov3d[..., 5]

    def sigma_row(a, b, cc):
        return (
            c0 * a + c1 * b + c2 * cc,
            c1 * a + c3 * b + c4 * cc,
            c2 * a + c4 * b + c5 * cc,
        )

    def dotr(s, r):
        return s[0] * r[0] + s[1] * r[1] + s[2] * r[2]

    r0, r1, r2 = Rwv[0], Rwv[1], Rwv[2]
    s0 = sigma_row(r0[0], r0[1], r0[2])
    s1 = sigma_row(r1[0], r1[1], r1[2])
    s2 = sigma_row(r2[0], r2[1], r2[2])
    V00 = dotr(s0, r0)
    V01 = dotr(s0, r1)
    V02 = dotr(s0, r2)
    V11 = dotr(s1, r1)
    V12 = dotr(s1, r2)
    V22 = dotr(s2, r2)

    cxx = j00 * (V00 * j00 + V02 * j02) + j02 * (V02 * j00 + V22 * j02) + 0.3
    cxy = j00 * (V01 * j11 + V02 * j12) + j02 * (V12 * j11 + V22 * j12)
    cyy = j11 * (V11 * j11 + V12 * j12) + j12 * (V12 * j11 + V22 * j12) + 0.3
    return torch.stack([cxx, cxy, cyy], dim=-1)


def ndc2pix(v, size):
    return ((v + 1.0) * size - 1.0) * 0.5


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space quantities."""

    valid: torch.Tensor  # [N] bool: survives culling and touches a tile
    depths: torch.Tensor  # [N] view-space z
    means2d: torch.Tensor  # [N, 2] pixel coordinates
    conic: torch.Tensor  # [N, 3] inverse 2D covariance (a, b, c)
    opacities: torch.Tensor  # [N]
    colors: torch.Tensor  # [N, 3]
    radii: torch.Tensor  # [N] int32 screen radius (0 if culled)
    rect_min: torch.Tensor  # [N, 2] int32 tile rect (x, y)
    rect_max: torch.Tensor  # [N, 2] int32 tile rect, exclusive
    tiles_touched: torch.Tensor  # [N] int32


def _tile_index(v, size, grid):
    # clamp in float before the cast, so out-of-range values saturate
    return torch.clamp(torch.floor(v / size), 0, grid).to(torch.int32)


def get_rect(means2d, radius_x, grid_x, grid_y, radius_y=None):
    """Tile rect of a splat with half-extents (radius_x, radius_y)."""
    if radius_y is None:
        radius_y = radius_x
    px, py = means2d[..., 0], means2d[..., 1]
    rmin_x = _tile_index(px - radius_x, TILE_X, grid_x)
    rmin_y = _tile_index(py - radius_y, TILE_Y, grid_y)
    rmax_x = _tile_index(px + radius_x + TILE_X - 1, TILE_X, grid_x)
    rmax_y = _tile_index(py + radius_y + TILE_Y - 1, TILE_Y, grid_y)
    return torch.stack([rmin_x, rmin_y], -1), torch.stack([rmax_x, rmax_y], -1)


def preprocess(
    means3d,
    opacities,
    viewmatrix,
    projmatrix,
    campos,
    image_width: int,
    image_height: int,
    tan_fovx: float,
    tan_fovy: float,
    *,
    shs=None,
    sh_degree: int = 3,
    colors_precomp=None,
    scales=None,
    rotations=None,
    cov3d_precomp=None,
    scale_modifier: float = 1.0,
    means2d_offset=None,
    antialias: bool = False,
    intrinsics=None,
) -> Preprocessed:
    """Full per-Gaussian preprocess (the CUDA reference's preprocessCUDA).

    ``means2d_offset`` [N, 2] is added to the pixel means; its gradient is
    the screen-space position gradient that densification accumulates.
    """
    if antialias:
        raise NotImplementedError("antialiased preprocess comes with the gsplat slice")
    if intrinsics is not None:
        raise NotImplementedError("intrinsics preprocess comes with the gsplat slice")
    grid_x = (image_width + TILE_X - 1) // TILE_X
    grid_y = (image_height + TILE_Y - 1) // TILE_Y

    p_view = transform_points(means3d, viewmatrix)[..., :3]
    depths = p_view[..., 2]
    in_front = depths > NEAR_CULL_Z

    if cov3d_precomp is not None:
        cov3d = cov3d_precomp
    else:
        cov3d = build_cov3d(scales, scale_modifier, rotations)

    p_hom = transform_points(means3d, projmatrix)
    # keep the denominator away from 0 so culled rows near w=0 stay finite
    p_w = 1.0 / _signed_clamp(p_hom[..., 3] + 1e-7, 1e-4)
    p_proj = p_hom[..., :3] * p_w[..., None]
    focal_x = image_width / (2.0 * tan_fovx)
    focal_y = image_height / (2.0 * tan_fovy)
    mean2d = torch.stack(
        [ndc2pix(p_proj[..., 0], image_width), ndc2pix(p_proj[..., 1], image_height)], -1)

    cov2d = compute_cov2d(means3d, focal_x, focal_y, tan_fovx, tan_fovy, cov3d, viewmatrix)

    det = cov2d[..., 0] * cov2d[..., 2] - cov2d[..., 1] * cov2d[..., 1]
    # det > 0 (not != 0): a NaN det must not pass into binning
    det_ok = det > 0.0
    det_inv = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    conic = torch.stack(
        [cov2d[..., 2] * det_inv, -cov2d[..., 1] * det_inv, cov2d[..., 0] * det_inv], -1)

    if means2d_offset is not None:
        mean2d = mean2d + means2d_offset

    mid = 0.5 * (cov2d[..., 0] + cov2d[..., 2])
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lambda1 = mid + disc
    lambda2 = mid - disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, lambda2)))

    # Binning rect: the 3-sigma circle's square intersected with the bbox of
    # the support ellipse d^T cov2d^-1 d <= 2 ln(255 op); outside it alpha
    # < 1/255 and the compositor skips the pixel anyway.
    op_flat = torch.reshape(opacities, (-1,))
    r_support = torch.sqrt(
        torch.clamp_min(2.0 * torch.log(255.0 * torch.clamp_min(op_flat, 1e-12)), 0.0)
        + 1e-12
    )
    # op <= 1/255 keeps an empty bbox
    supported = op_flat > (1.0 / 255.0)
    bbox_x = torch.where(supported, torch.ceil(torch.minimum(
        radius_f, r_support * torch.sqrt(torch.clamp_min(cov2d[..., 0], 0.0) + 1e-12))), 0.0)
    bbox_y = torch.where(supported, torch.ceil(torch.minimum(
        radius_f, r_support * torch.sqrt(torch.clamp_min(cov2d[..., 2], 0.0) + 1e-12))), 0.0)
    rect_min, rect_max = get_rect(mean2d, bbox_x, grid_x, grid_y, bbox_y)
    rect_wh = rect_max - rect_min
    tiles = rect_wh[..., 0] * rect_wh[..., 1]

    # radii / visibility keep the reference's circle-rect criterion
    circ_min, circ_max = get_rect(mean2d, radius_f, grid_x, grid_y)
    circ_wh = circ_max - circ_min
    vis = in_front & det_ok & ((circ_wh[..., 0] * circ_wh[..., 1]) > 0)
    valid = in_front & det_ok & (tiles > 0)

    if colors_precomp is not None:
        colors = colors_precomp
    else:
        max_deg = min(sh_ops.MAX_DEGREE, int(round(shs.shape[1] ** 0.5)) - 1)
        colors, _clamped = sh_ops.sh_to_rgb_clamped(sh_degree, shs, means3d, campos, max_deg)

    zero = torch.zeros((), dtype=torch.int32, device=means3d.device)
    return Preprocessed(
        valid=valid,
        depths=depths,
        means2d=mean2d,
        conic=conic,
        opacities=op_flat,
        colors=colors,
        radii=torch.where(vis, radius_f.to(torch.int32), zero),
        rect_min=rect_min,
        rect_max=rect_max,
        tiles_touched=torch.where(valid, tiles, zero),
    )


def mark_visible(means3d, viewmatrix, projmatrix=None):
    """Frustum visibility: view-space z > 0.2 (projmatrix unused, like the reference)."""
    del projmatrix
    p_view = transform_points(means3d, viewmatrix)[..., :3]
    return p_view[..., 2] > NEAR_CULL_Z
