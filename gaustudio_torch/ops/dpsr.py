"""Differentiable Poisson surface reconstruction, Shape-As-Points' DPSR
(port of gaustudio_tpu/ops/dpsr.py).

Oriented points in (0, 1)^3 are splatted trilinearly onto a periodic grid
(``point_rasterize``, an ``index_add_``), solved in the spectral domain
(``torch.fft.rfftn``: divergence of the Gaussian-smoothed normal field over
the Laplacian, ``irfftn``), shifted so the points sit at level 0 and scaled
so the grid's corner reads 0.5. ``mc_from_psr`` meshes the grid with the
port's marching tetrahedra, and ``PSR2Mesh`` carries Shape-As-Points'
backward rule from mesh vertices to the grid. Everything runs on the
points' device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def fftfreqs(res, device=None) -> torch.Tensor:
    """float32 [*res[:-1], res[-1] // 2 + 1, len(res)] frequency grid, the
    last axis in rfft layout."""
    freqs = [np.fft.fftfreq(r, d=1.0 / r) for r in res[:-1]]
    freqs.append(np.fft.rfftfreq(res[-1], d=1.0 / res[-1]))
    omega = np.stack(np.meshgrid(*freqs, indexing="ij"), axis=-1)
    return torch.as_tensor(omega.astype(np.float32), device=device)


def spec_gaussian_filter(res, sig, device=None) -> torch.Tensor:
    """The spectral Gaussian smoothing of the normal field, rfft layout."""
    omega = fftfreqs(res, device)
    dis = torch.sqrt(torch.sum(omega ** 2, dim=-1))
    return torch.exp(-0.5 * ((sig * 2.0 * dis / res[0]) ** 2))


def _corner_data(pts: torch.Tensor, size):
    """Trilinear corner indices [N, 8, 3] (periodic wrap) and weights [N, 8]
    of points in (0, 1). The cell index is floor(pts / (1 / size)), in
    float32 as the JAX package computes it: pts * size rounds differently."""
    device = pts.device
    dim = pts.shape[-1]
    size_t = torch.tensor(size, dtype=torch.int64, device=device)
    cubesize = 1.0 / size_t.to(torch.float32)
    ind0 = torch.floor(pts / cubesize).to(torch.int64)  # [N, dim]
    corners = torch.as_tensor(np.stack(np.meshgrid(*([np.array([0, 1])] * dim), indexing="ij"),
                                       -1).reshape(-1, dim), device=device)  # [2**dim, dim]
    idx = torch.remainder(ind0[:, None, :] + corners[None], size_t)
    # weight = prod over dims of |pts - opposite corner| / cube
    opp_pos = (ind0[:, None, :] + (1 - corners)[None]).to(torch.float32) * cubesize
    w = torch.prod(torch.abs(pts[:, None, :] - opp_pos) / cubesize, dim=-1)
    return idx, w


def grid_interp(grid: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Trilinear periodic interpolation: grid [X, Y, Z, F], pts [N, 3] in
    (0, 1) -> [N, F]."""
    idx, w = _corner_data(pts, tuple(grid.shape[:-1]))
    vals = grid[idx[..., 0], idx[..., 1], idx[..., 2]]  # [N, 8, F]
    return torch.sum(vals * w[..., None], dim=-2)


def point_rasterize(pts: torch.Tensor, vals: torch.Tensor, size, weighted: bool = False):
    """Trilinear scatter of point values onto a periodic grid: pts [N, 3],
    vals [N, F] -> [F, *size] (the adjoint of ``grid_interp``)."""
    nf = vals.shape[-1]
    idx, w = _corner_data(pts, size)
    flat = (idx[..., 0] * size[1] + idx[..., 1]) * size[2] + idx[..., 2]  # [N, 8]
    contrib = w[..., None] * vals[:, None, :]  # [N, 8, F]
    total = int(np.prod(size))
    out = torch.zeros((total, nf), dtype=vals.dtype, device=vals.device).index_add(
        0, flat.reshape(-1), contrib.reshape(-1, nf))
    if weighted:
        cnt = torch.zeros(total, dtype=vals.dtype, device=vals.device).index_add(
            0, flat.reshape(-1), torch.ones_like(w).reshape(-1))
        out = out / torch.where(cnt == 0, 1.0, cnt)[:, None]
    return torch.movedim(out.reshape(*size, nf), -1, 0)


def dpsr_solve(points: torch.Tensor, normals: torch.Tensor, res: Tuple[int, int, int],
               sig: float = 10.0, scale: bool = True, shift: bool = True,
               weighted: bool = False) -> torch.Tensor:
    """Spectral Poisson solve: points [N, 3] in (0, 1) and their normals ->
    the indicator grid [*res], negative inside. Differentiable in both."""
    device = points.device
    ras = point_rasterize(points, normals, res, weighted=weighted)  # [3, X, Y, Z]
    ras_hat = torch.movedim(torch.fft.rfftn(ras, dim=(1, 2, 3)), 0, -1)  # [X, Y, Zr, 3]
    N_hat = ras_hat * spec_gaussian_filter(res, sig, device)[..., None]
    omega = fftfreqs(res, device) * (2.0 * np.pi)  # [X, Y, Zr, 3]
    div_n = torch.sum(-1j * omega * N_hat, dim=-1)
    lap = -torch.sum(omega ** 2, dim=-1)
    phi_hat = div_n / (lap + 1e-6)
    phi_hat[0, 0, 0] = 0.0  # the field's mean
    phi = torch.fft.irfftn(phi_hat, s=res, dim=(0, 1, 2)).to(torch.float32)

    if shift or scale:
        fv = grid_interp(phi[..., None], points)[:, 0]
        if shift:
            phi = phi - torch.mean(fv)
        fv0 = phi[0, 0, 0].detach()
        if scale:
            phi = -phi / torch.abs(fv0) * 0.5
    return phi


class PSR2Mesh(torch.autograd.Function):
    """Identity on the mesh vertices that carries Shape-As-Points' backward
    rule to the grid: dL/dgrid = point_rasterize(verts, -normals . dL/dverts).
    The vertices and normals themselves get no gradient."""

    @staticmethod
    def forward(ctx, psr_grid, verts_unit, normals):
        ctx.save_for_backward(verts_unit, normals)
        ctx.grid_shape = tuple(psr_grid.shape)
        return verts_unit.clone()

    @staticmethod
    def backward(ctx, g):
        verts_unit, normals = ctx.saved_tensors
        grad_vert = torch.sum(g * (-normals), dim=-1, keepdim=True)  # [V, 1]
        return point_rasterize(verts_unit, grad_vert, ctx.grid_shape)[0], None, None


def psr_to_mesh_grid_grad(psr_grid, verts_unit, normals):
    return PSR2Mesh.apply(psr_grid, verts_unit, normals)


def mc_from_psr(psr_grid, zero_level: float = 0.0):
    """Indicator grid (on its device) -> host (verts in (0, 1) [V, 3], faces
    [F, 3], unit vertex normals [V, 3]) by marching tetrahedra."""
    from gaustudio_torch.ops.mcubes import marching_tetrahedra
    from gaustudio_torch.utils.mesh import vertex_normals

    grid = torch.as_tensor(psr_grid).detach()
    verts, faces = marching_tetrahedra(grid, iso=zero_level, voxel_size=1.0)
    verts_unit = verts / np.asarray(grid.shape, np.float32)
    vn = vertex_normals(verts, faces)
    return verts_unit.astype(np.float32), faces, vn.astype(np.float32)
