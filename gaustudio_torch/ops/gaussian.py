"""Per-Gaussian projection math — the rasterizer's preprocess stage.

Port of gaustudio_tpu/ops/gaussian.py: frustum culling, 3D covariance from
scale/quaternion, EWA 2D covariance with the fov clamp and the 0.3
low-pass, conic, screen radius and the tight tile rect (the 3-sigma circle
intersected with the opacity support ellipse).

:func:`preprocess` is the plain version, in torch ops. Expressions keep the
JAX package's operation order so both give the same float32 results. It
runs under autograd (the train step), on the CPU and with
``backend="plain"``. :func:`preprocess_forward` is kernel K7
(csrc/preprocess.cu), which computes the same outputs in one launch for
renders on the card that want no gradient. The JAX package has no Pallas
kernel here: it leaves preprocess to XLA's fusion, and K7 replaces the
~150 torch ops that took 17 of a 20 ms frame at 3M Gaussians (PERF.md).

``viewmatrix`` / ``projmatrix`` are the transposed W2V / W2V @ P matrices
(row-vector convention, ``p_view = (p, 1) @ viewmatrix``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaustudio_torch.ops import sh as sh_ops
from gaustudio_torch.utils import kernels

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

    ``intrinsics`` (fx, fy, cx, cy) selects gsplat's projection: the pixel
    mean is fx tx / tz + cx - 0.5 (the -0.5 puts gsplat's pixel centres on
    this compositor's integer grid), the EWA focal is fx / fy and the fov
    clamp uses tan_fov = 0.5 size / focal; ``projmatrix`` and ``tan_fov*``
    are ignored. ``antialias`` scales each opacity by
    sqrt(det(cov2d - 0.3 I) / det(cov2d)) (gsplat's antialiased mode) before
    the support rect is built from it.
    """
    grid_x = (image_width + TILE_X - 1) // TILE_X
    grid_y = (image_height + TILE_Y - 1) // TILE_Y

    p_view = transform_points(means3d, viewmatrix)[..., :3]
    depths = p_view[..., 2]
    in_front = depths > NEAR_CULL_Z

    if cov3d_precomp is not None:
        cov3d = cov3d_precomp
    else:
        cov3d = build_cov3d(scales, scale_modifier, rotations)

    if intrinsics is not None:
        focal_x, focal_y, cx, cy = (intrinsics[i] for i in range(4))
        tan_fovx = 0.5 * image_width / focal_x
        tan_fovy = 0.5 * image_height / focal_y
        tz = _signed_clamp(depths, NEAR_CULL_Z)  # as in compute_cov2d
        mean2d = torch.stack([focal_x * p_view[..., 0] / tz + cx - 0.5,
                              focal_y * p_view[..., 1] / tz + cy - 0.5], -1)
    else:
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
    if antialias:
        # det_inv is 0 on culled rows; +1e-12 keeps sqrt's gradient finite
        det_raw = (cov2d[..., 0] - 0.3) * (cov2d[..., 2] - 0.3) - cov2d[..., 1] * cov2d[..., 1]
        op_flat = op_flat * torch.sqrt(torch.clamp_min(det_raw, 0.0) * det_inv + 1e-12)
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
        max_deg = min(sh_ops.RASTER_MAX_DEGREE, int(round(shs.shape[1] ** 0.5)) - 1)
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


def preprocess_forward(
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
    """K7: :func:`preprocess` in one launch, for float32 CUDA tensors.

    Takes :func:`preprocess`'s arguments and returns its outputs, in the
    same dtypes and shapes, each a contiguous tensor of its own. The integer
    outputs, ``valid``, depth, mean, conic and opacity equal the plain
    version's; the colour differs from its SH sum by rounding. No gradient
    flows through it. Raises, before any launch, on an input that is not a
    float32 tensor of its shape on the current CUDA device.
    """
    if (shs is None) == (colors_precomp is None):
        raise ValueError("preprocess_forward: give exactly one of shs and colors_precomp")
    if cov3d_precomp is None and (scales is None or rotations is None):
        raise ValueError("preprocess_forward: give scales and rotations, or cov3d_precomp")
    n = means3d.shape[0] if means3d.dim() == 2 else -1
    inputs = {"means3d": (means3d, (n, 3)), "opacities": (opacities, None),
              "viewmatrix": (viewmatrix, (4, 4))}
    if intrinsics is None:
        inputs["projmatrix"] = (projmatrix, (4, 4))
    else:
        inputs["intrinsics"] = (intrinsics, (4,))
    coeffs, sh_stride = 0, 0
    if shs is not None:
        inputs["campos"] = (campos, (3,))
        num = shs.shape[1] if shs.dim() == 3 else 0
        max_deg = min(sh_ops.RASTER_MAX_DEGREE, int(round(num ** 0.5)) - 1)
        if num < 1 or (max_deg + 1) ** 2 > num:
            raise ValueError(f"preprocess_forward: shs of shape {tuple(shs.shape)} hold no "
                             "whole SH band")
        inputs["shs"] = (shs, (n, num, 3))
        coeffs, sh_stride = (max(min(sh_degree, max_deg), -1) + 1) ** 2, 3 * num
    else:
        inputs["colors_precomp"] = (colors_precomp, (n, 3))
    if cov3d_precomp is None:
        inputs["scales"] = (scales, (n, 3))
        inputs["rotations"] = (rotations, (n, 4))
    else:
        inputs["cov3d_precomp"] = (cov3d_precomp, (n, 6))
    if means2d_offset is not None:
        inputs["means2d_offset"] = (means2d_offset, (n, 2))
    for name, (t, shape) in inputs.items():
        if t.dtype != torch.float32:
            raise ValueError(f"preprocess_forward: {name} must be float32, got {t.dtype}")
        if (t.numel() != n) if shape is None else (tuple(t.shape) != shape):
            raise ValueError(f"preprocess_forward: {name} has shape {tuple(t.shape)}, expected "
                             f"{shape or (n,)} for {n} Gaussians (means3d {tuple(means3d.shape)})")
    for name, (t, _) in inputs.items():  # after every dtype and shape
        if not t.is_cuda:
            raise ValueError(f"preprocess_forward: {name} must be a CUDA tensor, got {t.device}")
    ins = {name: t.contiguous() for name, (t, _) in inputs.items()}
    kernels.require_cuda("preprocess_forward", *ins.values())

    device = means3d.device
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    out = Preprocessed(
        valid=torch.empty(n, dtype=torch.bool, device=device),
        depths=torch.empty(n, **f32),
        means2d=torch.empty((n, 2), **f32),
        conic=torch.empty((n, 3), **f32),
        opacities=torch.empty(n, **f32),
        colors=torch.empty((n, 3), **f32),
        radii=torch.empty(n, **i32),
        rect_min=torch.empty((n, 2), **i32),
        rect_max=torch.empty((n, 2), **i32),
        tiles_touched=torch.empty(n, **i32),
    )
    if n == 0:
        return out
    # the host scalars of the projection-matrix path, as preprocess computes them
    focal_x = focal_y = lim_x = lim_y = 0.0
    if intrinsics is None:
        focal_x = image_width / (2.0 * tan_fovx)
        focal_y = image_height / (2.0 * tan_fovy)
        lim_x, lim_y = 1.3 * tan_fovx, 1.3 * tan_fovy
    ptr = lambda name: ins[name].data_ptr() if name in ins else None  # noqa: E731
    kernels.check(kernels.load().gs_preprocess_forward(
        n, image_width, image_height, (image_width + TILE_X - 1) // TILE_X,
        (image_height + TILE_Y - 1) // TILE_Y, coeffs, sh_stride, int(antialias),
        scale_modifier, focal_x, focal_y, lim_x, lim_y,
        *(ptr(name) for name in ("means3d", "opacities", "scales", "rotations", "cov3d_precomp",
                                 "shs", "colors_precomp", "viewmatrix", "projmatrix", "campos",
                                 "intrinsics", "means2d_offset")),
        *(t.data_ptr() for t in out), kernels.stream()), "gs_preprocess_forward")
    preprocess_forward.launches += 1
    return out


preprocess_forward.launches = 0


def mark_visible(means3d, viewmatrix, projmatrix=None):
    """Frustum visibility: view-space z > 0.2 (projmatrix unused, like the reference)."""
    del projmatrix
    p_view = transform_points(means3d, viewmatrix)[..., :3]
    return p_view[..., 2] > NEAR_CULL_Z
