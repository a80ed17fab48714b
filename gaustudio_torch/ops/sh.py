"""Spherical-harmonics evaluation for degrees 0-3 (port of gaustudio_tpu/ops/sh.py).

Band order and signs follow the reference (band 1 is ``(-y, +z, -x)``).
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)

MAX_DEGREE = 3


def sh_basis(dirs: torch.Tensor, deg: int) -> torch.Tensor:
    """[..., 3] unit directions -> [..., (deg+1)**2] basis values."""
    if not 0 <= deg <= MAX_DEGREE:
        raise ValueError(f"SH degree {deg} is outside 0..{MAX_DEGREE}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    basis = [torch.full_like(x, C0)]
    if deg > 0:
        basis += [-C1 * y, C1 * z, -C1 * x]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if deg > 2:
        basis += [
            C3[0] * y * (3.0 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4.0 * zz - xx - yy),
            C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            C3[4] * x * (4.0 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(basis, dim=-1)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH colours: sh [..., C, K] (K >= (deg+1)**2), dirs [..., 3] -> [..., C].

    Not shifted by +0.5, like the reference.
    """
    coeff = (deg + 1) ** 2
    if sh.shape[-1] < coeff:
        raise ValueError(f"degree {deg} needs {coeff} coefficients, got {sh.shape[-1]}")
    basis = sh_basis(dirs, deg)
    return torch.einsum("...ck,...k->...c", sh[..., :coeff], basis)


def band_mask(active_deg: int, num_coeffs: int, dtype=torch.float32, device="cpu"):
    """0/1 mask over SH coefficients enabled at degree ``active_deg``."""
    ks = torch.arange(num_coeffs, device=device)
    bands = torch.floor(torch.sqrt(ks.to(torch.float64))).to(torch.int64)
    return (bands <= active_deg).to(dtype)


def eval_sh_masked(active_deg: int, sh: torch.Tensor, dirs: torch.Tensor,
                   max_deg: int = MAX_DEGREE) -> torch.Tensor:
    """Like eval_sh over ``max_deg`` bands, with bands above ``active_deg`` masked."""
    coeff = (max_deg + 1) ** 2
    mask = band_mask(active_deg, coeff, sh.dtype, sh.device)
    basis = sh_basis(dirs, max_deg) * mask
    return torch.einsum("...ck,...k->...c", sh[..., :coeff], basis)


def sh_to_rgb_clamped(active_deg: int, sh: torch.Tensor, means: torch.Tensor,
                      campos: torch.Tensor, max_deg: int = MAX_DEGREE):
    """View-dependent SH -> RGB with the +0.5 offset, clamped at 0.

    sh [N, K, 3] (band-major), means [N, 3], campos [3]. Returns
    (rgb [N, 3], clamped [N, 3] bool).
    """
    d = means - campos
    d = d * torch.rsqrt(torch.sum(d * d, dim=-1, keepdim=True) + 1e-18)
    rgb = eval_sh_masked(active_deg, sh.transpose(-1, -2), d, max_deg) + 0.5
    return torch.clamp_min(rgb, 0.0), rgb < 0.0


def RGB2SH(rgb):
    return (rgb - 0.5) / C0


def SH2RGB(sh):
    return sh * C0 + 0.5
