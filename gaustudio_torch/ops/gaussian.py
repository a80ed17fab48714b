"""Per-Gaussian projection math — the rasterizer's preprocess stage.

Port of gaustudio_tpu/ops/gaussian.py: frustum culling, 3D covariance from
scale/quaternion, EWA 2D covariance with the fov clamp and the 0.3
low-pass, conic, screen radius and the tight tile rect (the 3-sigma circle
intersected with the opacity support ellipse).

:func:`preprocess` is the plain version, in torch ops. Expressions keep the
JAX package's operation order so both give the same float32 results. It
runs on the CPU and, under torch autograd, with ``backend="plain"``.
:func:`preprocess_forward` is kernel K7 (csrc/preprocess.cu), which
computes the same outputs in one launch on the card, and
:func:`preprocess_backward` kernel K8, their vector-Jacobian product
(:func:`preprocess_backward_plain` its plain version, the same formulas in
torch ops). :func:`preprocess_with_grad` joins the two in an autograd
Function for the train step. The JAX package has no Pallas kernel here: it
leaves preprocess to XLA's fusion and its gradient to jax.grad. K7 replaces
the ~150 torch ops that took 17 of a 20 ms frame at 3M Gaussians, and K7
with K8 those ops and their autograd, ~45 of a 77 ms training step
(PERF.md).

``viewmatrix`` / ``projmatrix`` are the transposed W2V / W2V @ P matrices
(row-vector convention, ``p_view = (p, 1) @ viewmatrix``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaustudio_torch.ops import sh as sh_ops
from gaustudio_torch.utils import kernels
from gaustudio_torch.utils.observability import annotate, count

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


def _kernel_inputs(fn: str, means3d, opacities, viewmatrix, projmatrix, campos, image_width,
                   image_height, tan_fovx, tan_fovy, *, shs, sh_degree, colors_precomp, scales,
                   rotations, cov3d_precomp, means2d_offset, intrinsics):
    """Checks K7's and K8's inputs (they take preprocess's) and raises, before
    any launch, on one that is not a float32 tensor of its shape on the
    current CUDA device. Returns (n, the SH coefficients to read, the floats
    of an SH row, {name: contiguous tensor}, the host scalars (focal_x,
    focal_y, lim_x, lim_y) of the projection-matrix path, as preprocess
    computes them)."""
    if (shs is None) == (colors_precomp is None):
        raise ValueError(f"{fn}: give exactly one of shs and colors_precomp")
    if cov3d_precomp is None and (scales is None or rotations is None):
        raise ValueError(f"{fn}: give scales and rotations, or cov3d_precomp")
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
            raise ValueError(f"{fn}: shs of shape {tuple(shs.shape)} hold no whole SH band")
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
            raise ValueError(f"{fn}: {name} must be float32, got {t.dtype}")
        if (t.numel() != n) if shape is None else (tuple(t.shape) != shape):
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected "
                             f"{shape or (n,)} for {n} Gaussians (means3d {tuple(means3d.shape)})")
    for name, (t, _) in inputs.items():  # after every dtype and shape
        if not t.is_cuda:
            raise ValueError(f"{fn}: {name} must be a CUDA tensor, got {t.device}")
    ins = {name: t.contiguous() for name, (t, _) in inputs.items()}
    kernels.require_cuda(fn, *ins.values())
    host = (0.0, 0.0, 0.0, 0.0)
    if intrinsics is None:
        host = (image_width / (2.0 * tan_fovx), image_height / (2.0 * tan_fovy),
                1.3 * tan_fovx, 1.3 * tan_fovy)
    return n, coeffs, sh_stride, ins, host


_CAMERA = ("viewmatrix", "projmatrix", "campos", "intrinsics")


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
    flows through it (:func:`preprocess_with_grad` pairs it with K8). Raises,
    before any launch, on an input that is not a float32 tensor of its shape
    on the current CUDA device.
    """
    n, coeffs, sh_stride, ins, host = _kernel_inputs(
        "preprocess_forward", means3d, opacities, viewmatrix, projmatrix, campos, image_width,
        image_height, tan_fovx, tan_fovy, shs=shs, sh_degree=sh_degree,
        colors_precomp=colors_precomp, scales=scales, rotations=rotations,
        cov3d_precomp=cov3d_precomp, means2d_offset=means2d_offset, intrinsics=intrinsics)
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
    ptr = lambda name: ins[name].data_ptr() if name in ins else None  # noqa: E731
    kernels.check(kernels.load().gs_preprocess_forward(
        n, image_width, image_height, (image_width + TILE_X - 1) // TILE_X,
        (image_height + TILE_Y - 1) // TILE_Y, coeffs, sh_stride, int(antialias),
        scale_modifier, *host,
        *(ptr(name) for name in ("means3d", "opacities", "scales", "rotations", "cov3d_precomp",
                                 "shs", "colors_precomp", "viewmatrix", "projmatrix", "campos",
                                 "intrinsics", "means2d_offset")),
        *(t.data_ptr() for t in out), kernels.stream()), "gs_preprocess_forward")
    preprocess_forward.launches += 1
    return out


preprocess_forward.launches = 0


class PreprocessGrads(NamedTuple):
    """The gradients of :func:`preprocess`'s differentiable inputs, each
    None where that input was not given."""

    means3d: torch.Tensor
    opacities: torch.Tensor
    shs: torch.Tensor
    colors_precomp: torch.Tensor
    scales: torch.Tensor
    rotations: torch.Tensor
    cov3d_precomp: torch.Tensor
    means2d_offset: torch.Tensor


def _signed_clamp_passes(v, floor):
    """Where :func:`_signed_clamp` passes its gradient (False on NaN)."""
    return torch.where(v >= 0.0, v >= floor, v <= -floor)


def preprocess_backward_plain(
    means3d, opacities, viewmatrix, projmatrix, campos, image_width: int, image_height: int,
    tan_fovx: float, tan_fovy: float, *, shs=None, sh_degree: int = 3, colors_precomp=None,
    scales=None, rotations=None, cov3d_precomp=None, scale_modifier: float = 1.0,
    means2d_offset=None, antialias: bool = False, intrinsics=None, d_depths=None,
    d_means2d=None, d_conic=None, d_opacities=None, d_colors=None,
) -> PreprocessGrads:
    """Plain version of K8: the vector-Jacobian product of :func:`preprocess`.

    Takes preprocess's arguments and the gradients of its differentiable
    outputs (``d_depths`` [N], ``d_means2d`` [N, 2], ``d_conic`` [N, 3],
    ``d_opacities`` [N], ``d_colors`` [N, 3]; None reads as zeros) and
    returns those of its inputs, as torch autograd through preprocess gives
    them up to rounding: the same gates at every clamp (closed intervals),
    signed clamp, ``det > 0`` and colour clamped at 0, and zero through the
    rounded radius, support and rects. Written out by hand: the forward's
    intermediates are recomputed from the inputs, with the ops that decide
    a gate (depth, the fov clamp, det, the colour) as preprocess has them.
    ``means2d_offset``, ``colors_precomp`` and, without ``antialias``,
    ``opacities`` take their output's gradient unchanged.
    """
    n = means3d.shape[0]
    zeros = lambda *shape: means3d.new_zeros(shape)  # noqa: E731
    g_depth = zeros(n) if d_depths is None else d_depths.reshape(n)
    g_mean = zeros(n, 2) if d_means2d is None else d_means2d
    g_conic = zeros(n, 3) if d_conic is None else d_conic
    g_op = zeros(n) if d_opacities is None else d_opacities.reshape(n)
    g_col = zeros(n, 3) if d_colors is None else d_colors

    p_view = transform_points(means3d, viewmatrix)[..., :3]
    vx, vy, vz = p_view.unbind(-1)
    cov3d = (cov3d_precomp if cov3d_precomp is not None
             else build_cov3d(scales, scale_modifier, rotations))
    if intrinsics is not None:
        focal_x, focal_y = intrinsics[0], intrinsics[1]
        tan_fovx = 0.5 * image_width / focal_x
        tan_fovy = 0.5 * image_height / focal_y
    else:
        focal_x = image_width / (2.0 * tan_fovx)
        focal_y = image_height / (2.0 * tan_fovy)
    cov2d = compute_cov2d(means3d, focal_x, focal_y, tan_fovx, tan_fovy, cov3d, viewmatrix)
    cxx, cxy, cyy = cov2d.unbind(-1)
    det = cxx * cyy - cxy * cxy
    det_ok = det > 0.0
    det_inv = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)

    # conic (and opacity) -> cov2d
    d_det_inv = g_conic[:, 0] * cyy - g_conic[:, 1] * cxy + g_conic[:, 2] * cxx
    d_cxx = g_conic[:, 2] * det_inv
    d_cxy = -g_conic[:, 1] * det_inv
    d_cyy = g_conic[:, 0] * det_inv
    d_opacities_in = g_op
    if antialias:
        det_raw = (cxx - 0.3) * (cyy - 0.3) - cxy * cxy
        root = torch.sqrt(torch.clamp_min(det_raw, 0.0) * det_inv + 1e-12)
        d_opacities_in = g_op * root
        d_f = g_op * torch.reshape(opacities, (-1,)) * 0.5 / root
        d_raw = torch.where(det_raw >= 0.0, d_f * det_inv, 0.0)
        d_det_inv = d_det_inv + d_f * torch.clamp_min(det_raw, 0.0)
        d_cxx = d_cxx + d_raw * (cyy - 0.3)
        d_cyy = d_cyy + d_raw * (cxx - 0.3)
        d_cxy = d_cxy - 2.0 * cxy * d_raw
    d_det = torch.where(det_ok, -d_det_inv * det_inv * det_inv, 0.0)
    d_cxx = d_cxx + d_det * cyy
    d_cyy = d_cyy + d_det * cxx
    d_cxy = d_cxy - 2.0 * cxy * d_det

    # cov2d = J V J^T + 0.3 I -> the Jacobian J and the view covariance V
    tz = _signed_clamp(vz, NEAR_CULL_Z)
    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    txtz, tytz = vx / tz, vy / tz
    cx_, cy_ = torch.clamp(txtz, -limx, limx), torch.clamp(tytz, -limy, limy)
    tx, ty = cx_ * tz, cy_ * tz
    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    j00, j11 = focal_x * inv_tz, focal_y * inv_tz
    j02, j12 = -focal_x * tx * inv_tz2, -focal_y * ty * inv_tz2
    Rwv = viewmatrix[:3, :3].T  # rows: the view axes in the world
    sigma = torch.stack([cov3d[:, [0, 1, 2]], cov3d[:, [1, 3, 4]], cov3d[:, [2, 4, 5]]], 1)
    Vc = torch.einsum("ia,nab,jb->nij", Rwv, sigma, Rwv)
    V00, V01, V02 = Vc[:, 0, 0], Vc[:, 0, 1], Vc[:, 0, 2]
    V11, V12, V22 = Vc[:, 1, 1], Vc[:, 1, 2], Vc[:, 2, 2]
    dV00 = d_cxx * j00 * j00
    dV01 = d_cxy * j00 * j11
    dV02 = 2.0 * d_cxx * j00 * j02 + d_cxy * j00 * j12
    dV11 = d_cyy * j11 * j11
    dV12 = d_cxy * j02 * j11 + 2.0 * d_cyy * j11 * j12
    dV22 = d_cxx * j02 * j02 + d_cxy * j02 * j12 + d_cyy * j12 * j12
    d_j00 = 2.0 * d_cxx * (V00 * j00 + V02 * j02) + d_cxy * (V01 * j11 + V02 * j12)
    d_j02 = 2.0 * d_cxx * (V02 * j00 + V22 * j02) + d_cxy * (V12 * j11 + V22 * j12)
    d_j11 = 2.0 * d_cyy * (V11 * j11 + V12 * j12) + d_cxy * (V01 * j00 + V12 * j02)
    d_j12 = 2.0 * d_cyy * (V12 * j11 + V22 * j12) + d_cxy * (V02 * j00 + V22 * j02)

    # J -> the view-space mean, through the fov clamp
    d_inv_tz = (focal_x * d_j00 + focal_y * d_j11
                + 2.0 * inv_tz * (-focal_x * tx * d_j02 - focal_y * ty * d_j12))
    d_tx = -focal_x * inv_tz2 * d_j02
    d_ty = -focal_y * inv_tz2 * d_j12
    d_tz = -d_inv_tz * inv_tz * inv_tz + d_tx * cx_ + d_ty * cy_
    d_txtz = torch.where((txtz >= -limx) & (txtz <= limx), d_tx * tz, 0.0)
    d_tytz = torch.where((tytz >= -limy) & (tytz <= limy), d_ty * tz, 0.0)
    d_vx = d_txtz / tz
    d_vy = d_tytz / tz
    d_tz = d_tz - (d_txtz * vx + d_tytz * vy) / (tz * tz)

    # the pixel mean
    d_means3d = zeros(n, 3)
    if intrinsics is not None:
        d_vx = d_vx + g_mean[:, 0] * focal_x / tz
        d_vy = d_vy + g_mean[:, 1] * focal_y / tz
        d_tz = d_tz - (g_mean[:, 0] * focal_x * vx + g_mean[:, 1] * focal_y * vy) / (tz * tz)
    else:
        p_hom = transform_points(means3d, projmatrix)
        w = p_hom[..., 3] + 1e-7
        p_w = 1.0 / _signed_clamp(w, 1e-4)
        d_h0 = g_mean[:, 0] * (0.5 * image_width) * p_w
        d_h1 = g_mean[:, 1] * (0.5 * image_height) * p_w
        d_pw = (g_mean[:, 0] * (0.5 * image_width) * p_hom[..., 0]
                + g_mean[:, 1] * (0.5 * image_height) * p_hom[..., 1])
        d_h3 = torch.where(_signed_clamp_passes(w, 1e-4), -d_pw * p_w * p_w, 0.0)
        d_means3d = d_means3d + torch.stack([d_h0, d_h1, d_h3], -1) @ projmatrix[:3, [0, 1, 3]].T
    d_vz = g_depth + torch.where(_signed_clamp_passes(vz, NEAR_CULL_Z), d_tz, 0.0)
    d_means3d = d_means3d + torch.stack([d_vx, d_vy, d_vz], -1) @ viewmatrix[:3, :3].T

    # V = Rwv Sigma Rwv^T -> the 3D covariance
    half = lambda v: 0.5 * v  # noqa: E731
    G = torch.stack([torch.stack([dV00, half(dV01), half(dV02)], -1),
                     torch.stack([half(dV01), dV11, half(dV12)], -1),
                     torch.stack([half(dV02), half(dV12), dV22], -1)], 1)
    dS = torch.einsum("ia,nij,jb->nab", Rwv, G, Rwv)
    d_cov3d = torch.stack([dS[:, 0, 0], 2.0 * dS[:, 0, 1], 2.0 * dS[:, 0, 2], dS[:, 1, 1],
                           2.0 * dS[:, 1, 2], dS[:, 2, 2]], -1)
    d_scales = d_rotations = None
    if cov3d_precomp is None:
        d_scales, d_rotations = _build_cov3d_backward(scales, scale_modifier, rotations, d_cov3d)
        d_cov3d = None

    d_shs = None
    if shs is not None:
        num = shs.shape[1]
        max_deg = min(sh_ops.RASTER_MAX_DEGREE, int(round(num ** 0.5)) - 1)
        coeff = (max_deg + 1) ** 2
        d = means3d - campos
        inv = torch.rsqrt(torch.sum(d * d, dim=-1, keepdim=True) + 1e-18)
        dirs = d * inv
        mask = sh_ops.band_mask(sh_degree, coeff, shs.dtype, shs.device)
        basis = sh_ops.sh_basis(dirs, max_deg) * mask
        rgb = torch.einsum("...ck,...k->...c", shs.transpose(-1, -2)[..., :coeff], basis) + 0.5
        d_rgb = torch.where(rgb >= 0.0, g_col, 0.0)  # clamp_min's gate
        d_shs = torch.zeros_like(shs)
        d_shs[:, :coeff] = basis[:, :, None] * d_rgb[:, None, :]
        d_basis = torch.einsum("nkc,nc->nk", shs[:, :coeff], d_rgb) * mask
        d_dirs = sh_ops.sh_basis_backward(dirs, d_basis)
        d_means3d = d_means3d + inv * d_dirs - inv ** 3 * d * torch.sum(d * d_dirs, -1,
                                                                         keepdim=True)
    return PreprocessGrads(
        means3d=d_means3d, opacities=d_opacities_in.reshape(opacities.shape), shs=d_shs,
        colors_precomp=None if colors_precomp is None else g_col, scales=d_scales,
        rotations=d_rotations, cov3d_precomp=d_cov3d,
        means2d_offset=None if means2d_offset is None else g_mean)


def _build_cov3d_backward(scale, scale_modifier, quat, d_cov3d):
    """The vector-Jacobian product of :func:`build_cov3d`: (d_scale, d_quat)."""
    r, x, y, z = quat.unbind(-1)
    M = torch.stack([
        torch.stack([1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z),
                     2.0 * (x * z + r * y)], -1),
        torch.stack([2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z),
                     2.0 * (y * z - r * x)], -1),
        torch.stack([2.0 * (x * z - r * y), 2.0 * (y * z + r * x),
                     1.0 - 2.0 * (x * x + y * y)], -1),
    ], 1)  # [N, 3, 3], M[:, a, k]
    s = scale_modifier * scale
    sq = s * s
    dc = d_cov3d.unbind(-1)
    # symmetric: dC[a][b] is the gradient of Sigma_ab, off the diagonal counted once
    dC = torch.stack([torch.stack([2.0 * dc[0], dc[1], dc[2]], -1),
                      torch.stack([dc[1], 2.0 * dc[3], dc[4]], -1),
                      torch.stack([dc[2], dc[4], 2.0 * dc[5]], -1)], 1)
    dCM = torch.einsum("nab,nbk->nak", dC, M)  # sum_b dC_ab M_bk
    d_sq = 0.5 * torch.sum(M * dCM, dim=1)  # [N, 3]
    dM = dCM * sq[:, None, :]
    d_scale = d_sq * 2.0 * s * scale_modifier
    m = dM.reshape(-1, 9).unbind(-1)  # dM00 dM01 dM02 dM10 ... dM22
    d_r = 2.0 * (-z * m[1] + y * m[2] + z * m[3] - x * m[5] - y * m[6] + x * m[7])
    d_x = 2.0 * (y * m[1] + z * m[2] + y * m[3] - 2.0 * x * m[4] - r * m[5] + z * m[6]
                 + r * m[7] - 2.0 * x * m[8])
    d_y = 2.0 * (-2.0 * y * m[0] + x * m[1] + r * m[2] + x * m[3] + z * m[5] - r * m[6]
                 + z * m[7] - 2.0 * y * m[8])
    d_z = 2.0 * (-2.0 * z * m[0] - r * m[1] + x * m[2] + r * m[3] - 2.0 * z * m[4] + y * m[5]
                 + x * m[6] + y * m[7])
    return d_scale, torch.stack([d_r, d_x, d_y, d_z], -1)


# The upstream gradients K8 reads: [N] or [N, k] rows, each with a stride of
# its own (K4's accumulator is read in place)
_COTANGENTS = (("d_depths", 1), ("d_means2d", 2), ("d_conic", 3), ("d_opacities", 1),
               ("d_colors", 3))


def preprocess_backward(means3d, opacities, viewmatrix, projmatrix, campos, image_width: int,
                        image_height: int, tan_fovx: float, tan_fovy: float, **kw
                        ) -> PreprocessGrads:
    """K8: :func:`preprocess_backward_plain` in one launch for CUDA tensors
    (the plain version for CPU tensors), with the same arguments and result.

    The gradients of means3d, opacities (with ``antialias``), scales and
    rotations or cov3d_precomp, and shs come from the kernel; the others are
    their outputs' gradients, unchanged. The upstream gradients may be
    strided rows (K4's [N, 10] accumulator, read in place); each must be
    float32 on the inputs' device. Raises, before any launch, where an input
    is not what K7 takes or an upstream gradient not of its shape.
    """
    if not means3d.is_cuda:
        return preprocess_backward_plain(means3d, opacities, viewmatrix, projmatrix, campos,
                                         image_width, image_height, tan_fovx, tan_fovy, **kw)
    cot = {name: kw.pop(name, None) for name, _ in _COTANGENTS}
    n, coeffs, sh_stride, ins, host = _kernel_inputs(
        "preprocess_backward", means3d, opacities, viewmatrix, projmatrix, campos, image_width,
        image_height, tan_fovx, tan_fovy, shs=kw.get("shs"), sh_degree=kw.get("sh_degree", 3),
        colors_precomp=kw.get("colors_precomp"), scales=kw.get("scales"),
        rotations=kw.get("rotations"), cov3d_precomp=kw.get("cov3d_precomp"),
        means2d_offset=kw.get("means2d_offset"), intrinsics=kw.get("intrinsics"))
    rows = []  # (pointer, row stride) of each upstream gradient, 0 for none
    for name, width in _COTANGENTS:
        t = cot[name]
        if t is None:
            rows.append((None, 0))
            continue
        if t.dtype != torch.float32 or t.device != means3d.device:
            raise ValueError(f"preprocess_backward: {name} must be float32 on {means3d.device}, "
                             f"got {t.dtype} on {t.device}")
        if t.numel() != n * width or (width > 1 and tuple(t.shape) != (n, width)):
            raise ValueError(f"preprocess_backward: {name} has shape {tuple(t.shape)}, expected "
                             f"{(n, width) if width > 1 else (n,)}")
        t = t.reshape(n, width)
        if t.stride(1) != 1 and width > 1:
            t = t.contiguous()
        cot[name] = t
        rows.append((t.data_ptr(), t.stride(0)))
    antialias = bool(kw.get("antialias", False))
    shs = ins.get("shs")
    out = dict(
        means3d=torch.empty_like(ins["means3d"]),
        opacities=torch.empty_like(ins["opacities"]) if antialias else None,
        shs=torch.empty_like(shs) if shs is not None else None,
        scales=torch.empty_like(ins["scales"]) if "scales" in ins else None,
        rotations=torch.empty_like(ins["rotations"]) if "rotations" in ins else None,
        cov3d_precomp=torch.empty_like(ins["cov3d_precomp"]) if "cov3d_precomp" in ins else None)
    if n > 0:
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        kernels.check(kernels.load().gs_preprocess_backward(
            n, image_width, image_height, coeffs, sh_stride, int(antialias),
            *(stride for _, stride in rows), kw.get("scale_modifier", 1.0), *host,
            *(ptr(ins.get(name)) for name in ("means3d", "opacities", "scales", "rotations",
                                              "cov3d_precomp", "shs") + _CAMERA),
            *(p for p, _ in rows),
            *(ptr(out[name]) for name in ("means3d", "opacities", "scales", "rotations",
                                          "cov3d_precomp", "shs")),
            kernels.stream()), "gs_preprocess_backward")
        preprocess_backward.launches += 1
    def passed(name, shape):  # an output's gradient, unchanged (zeros for none)
        t = cot[name]
        return means3d.new_zeros(shape) if t is None else t.reshape(shape)

    return PreprocessGrads(
        means3d=out["means3d"],
        opacities=out["opacities"] if antialias else passed("d_opacities", opacities.shape),
        shs=out["shs"],
        colors_precomp=None if kw.get("colors_precomp") is None else passed("d_colors", (n, 3)),
        scales=out["scales"], rotations=out["rotations"], cov3d_precomp=out["cov3d_precomp"],
        means2d_offset=None if kw.get("means2d_offset") is None else passed("d_means2d", (n, 2)))


preprocess_backward.launches = 0

class _Preprocess(torch.autograd.Function):
    """Forward K7 (:func:`preprocess_forward`), backward K8
    (:func:`preprocess_backward`); their plain versions for CPU tensors.
    Saves the inputs only: K8 recomputes the forward's intermediates. The
    integer outputs and ``valid`` are not differentiable; the camera takes
    no gradient."""

    @staticmethod
    def forward(ctx, means3d, opacities, shs, colors_precomp, scales, rotations, cov3d_precomp,
                means2d_offset, viewmatrix, projmatrix, campos, intrinsics, config):
        for name, t in zip(_CAMERA, (viewmatrix, projmatrix, campos, intrinsics)):
            if t is not None and t.requires_grad:
                raise ValueError(f"preprocess: {name} requires a gradient, which K8 does not "
                                 "compute; rasterize with backend='plain'")
        out = (preprocess_forward if means3d.is_cuda else preprocess)(
            means3d, opacities, viewmatrix, projmatrix, campos, shs=shs,
            colors_precomp=colors_precomp, scales=scales, rotations=rotations,
            cov3d_precomp=cov3d_precomp, means2d_offset=means2d_offset, intrinsics=intrinsics,
            **config)
        ctx.mark_non_differentiable(out.valid, out.radii, out.rect_min, out.rect_max,
                                    out.tiles_touched)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(means3d, opacities, shs, colors_precomp, scales, rotations,
                              cov3d_precomp, means2d_offset, viewmatrix, projmatrix, campos,
                              intrinsics)
        ctx.config = config
        return tuple(out)

    @staticmethod
    def backward(ctx, _d_valid, d_depths, d_means2d, d_conic, d_opacities, d_colors, *_ints):
        (means3d, opacities, shs, colors_precomp, scales, rotations, cov3d_precomp,
         means2d_offset, viewmatrix, projmatrix, campos, intrinsics) = ctx.saved_tensors
        count("gs.preprocess.kernel_bwd", int(means3d.is_cuda))
        with annotate("gs.preprocess_bwd", means3d):
            grads = preprocess_backward(
                means3d, opacities, viewmatrix, projmatrix, campos, shs=shs,
                colors_precomp=colors_precomp, scales=scales, rotations=rotations,
                cov3d_precomp=cov3d_precomp, means2d_offset=means2d_offset,
                intrinsics=intrinsics, d_depths=d_depths, d_means2d=d_means2d, d_conic=d_conic,
                d_opacities=d_opacities, d_colors=d_colors, **ctx.config)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None, None, None, None)


def preprocess_with_grad(means3d, opacities, viewmatrix, projmatrix, campos, image_width: int,
                         image_height: int, tan_fovx: float, tan_fovy: float, *, shs=None,
                         sh_degree: int = 3, colors_precomp=None, scales=None, rotations=None,
                         cov3d_precomp=None, scale_modifier: float = 1.0, means2d_offset=None,
                         antialias: bool = False, intrinsics=None) -> Preprocessed:
    """:func:`preprocess` for autograd through K7 and K8 (see
    :class:`_Preprocess`): its arguments and outputs, with gradients to
    every differentiable input but the camera."""
    config = dict(image_width=image_width, image_height=image_height, tan_fovx=tan_fovx,
                  tan_fovy=tan_fovy, sh_degree=sh_degree, scale_modifier=scale_modifier,
                  antialias=antialias)
    return Preprocessed(*_Preprocess.apply(
        means3d, opacities, shs, colors_precomp, scales, rotations, cov3d_precomp,
        means2d_offset, viewmatrix, projmatrix, campos, intrinsics, config))


def mark_visible(means3d, viewmatrix, projmatrix=None):
    """Frustum visibility: view-space z > 0.2 (projmatrix unused, like the reference)."""
    del projmatrix
    p_view = transform_points(means3d, viewmatrix)[..., :3]
    return p_view[..., 2] > NEAR_CULL_Z
