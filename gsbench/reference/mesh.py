"""Plain reference of gs-extract-mesh's fusion: masked median depths into a
TSDF grid, then the vertices and faces of marching tetrahedra.

The grid covers the 2nd-98th percentile box of the Gaussians' centres
padded by 5% of its size, with at most ``max_dim`` voxels along its longest
side (voxel and truncation grow together past that). A voxel centre is
projected into a view at the nearest pixel (round half to even); where it
lies in the image in front of the camera and the pixel's depth d > 0 gives
sdf = d - z > -trunc, it takes min(sdf / trunc, 1) into a running weighted
average, weight + 1, capped at 64. Each cube whose eight corners have
weight >= ``min_weight`` is split into six tetrahedra about its 0-7
diagonal; a tetrahedron edge whose ends lie on both sides of the zero level
(< 0 against >= 0) holds a vertex at the linear crossing, shared by every
tetrahedron that has the edge; a tetrahedron with one corner apart yields a
triangle, with two a quad as two triangles.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_WEIGHT = 64.0
_CORNERS = [(c & 1, (c >> 1) & 1, (c >> 2) & 1) for c in range(8)]
_TETS = [(0, 1, 3, 7), (0, 3, 2, 7), (0, 2, 6, 7), (0, 6, 4, 7), (0, 4, 5, 7), (0, 5, 1, 7)]
_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def grid(xyz: np.ndarray, voxel: float, trunc: float, max_dim: int):
    """(origin [3] float32, voxel, trunc, dims) of the fusion grid."""
    pts = np.asarray(xyz, np.float32)
    lo, hi = np.percentile(pts, 2, axis=0), np.percentile(pts, 98, axis=0)
    pad = 0.05 * (hi - lo + 1e-6)
    lo, hi = np.asarray(lo - pad, np.float64), np.asarray(hi + pad, np.float64)
    extent = float(np.max(hi - lo))
    if extent / voxel + 1 > max_dim:
        scale = (extent / (max_dim - 1)) / voxel
        voxel, trunc = voxel * scale, trunc * scale
    dims = tuple(int(d) for d in np.ceil((hi - lo) / voxel).astype(int) + 1)
    return lo.astype(np.float32), np.float32(voxel), np.float32(trunc), dims


def fuse(depths, views, origin, voxel, trunc, dims, device):
    """TSDF and weight grids [X, Y, Z] of depth maps ``depths`` [H, W]
    seen by ``views`` (``raster.View``)."""
    o = torch.as_tensor(origin, device=device)
    ax = [o[a] + torch.arange(n, device=device, dtype=torch.float32) * float(voxel)
          for a, n in enumerate(dims)]
    X, Y, Z = torch.meshgrid(*ax, indexing="ij")
    pts = torch.stack([X, Y, Z], -1).reshape(-1, 3)
    del X, Y, Z
    tsdf = torch.ones(pts.shape[0], device=device)
    weight = torch.zeros(pts.shape[0], device=device)
    for depth, v in zip(depths, views):
        depth = depth.float()
        H, W = depth.shape
        cam = pts @ v.viewmatrix[:3, :3].float() + v.viewmatrix[3, :3].float()
        z = cam[:, 2]
        u = cam[:, 0] / z * float(v.fx) + 0.5 * W
        w = cam[:, 1] / z * float(v.fy) + 0.5 * H
        inside = (z > 1e-4) & (u >= -0.5) & (u <= W - 0.5) & (w >= -0.5) & (w <= H - 0.5)
        ui = torch.round(u).clamp(0, W - 1).long()
        vi = torch.round(w).clamp(0, H - 1).long()
        d = depth[vi, ui]
        sdf = d - z
        upd = inside & (d > 0) & (sdf > -float(trunc))
        obs = torch.clamp_max(sdf / float(trunc), 1.0)
        w_new = weight + upd.float()
        tsdf = torch.where(upd, (tsdf * weight + obs) / torch.clamp_min(w_new, 1e-9), tsdf)
        weight = torch.clamp_max(w_new, MAX_WEIGHT)
    return tsdf.reshape(dims), weight.reshape(dims)


def march(tsdf, weight, min_weight: float, origin, voxel, slab: int = 16):
    """(vertices [V, 3] float64 numpy in world units, face count)."""
    Xn, Yn, Zn = tsdf.shape
    keys_all, pos_all, faces = [], [], 0
    for z0 in range(0, Zn - 1, slab):
        z1 = min(z0 + slab, Zn - 1)
        corner_v = [tsdf[dx:Xn - 1 + dx, dy:Yn - 1 + dy, z0 + dz:z1 + dz]
                    for dx, dy, dz in _CORNERS]
        corner_w = torch.stack([weight[dx:Xn - 1 + dx, dy:Yn - 1 + dy, z0 + dz:z1 + dz]
                                for dx, dy, dz in _CORNERS]).amin(0)
        ok = corner_w >= min_weight
        idx = torch.nonzero(ok)  # [C, 3] cube origins (z relative to z0)
        if idx.shape[0] == 0:
            continue
        vals = torch.stack([cv[ok] for cv in corner_v], 1)  # [C, 8]
        for tet in _TETS:
            tv = vals[:, list(tet)]
            inside = tv < 0.0
            count = inside.sum(1)
            faces += int((count % 4 != 0).sum()) + int((count == 2).sum())
            for a, b in _EDGES:
                cross = inside[:, a] != inside[:, b]
                if not bool(cross.any()):
                    continue
                base = idx[cross]
                ca, cb = torch.tensor(_CORNERS[tet[a]]), torch.tensor(_CORNERS[tet[b]])
                ga = base + ca.to(base.device)
                gb = base + cb.to(base.device)
                ga[:, 2] += z0
                gb[:, 2] += z0
                va, vb = tv[cross, a], tv[cross, b]
                den = vb - va
                t = torch.where(den.abs() > 1e-12, -va / den, torch.full_like(va, 0.5)).clamp(0, 1)
                pos = ga.float() + t[:, None] * (gb - ga).float()
                ka = (ga[:, 0] * Yn + ga[:, 1]) * (Zn + 1) + ga[:, 2]
                kb = (gb[:, 0] * Yn + gb[:, 1]) * (Zn + 1) + gb[:, 2]
                keys_all.append(torch.minimum(ka, kb) * (Xn * Yn * (Zn + 1) + 1)
                                + torch.maximum(ka, kb))
                pos_all.append(pos)
    if not keys_all:
        return np.zeros((0, 3)), 0
    keys = torch.cat(keys_all)
    pos = torch.cat(pos_all)
    uniq, first = np.unique(keys.cpu().numpy(), return_index=True)
    verts = pos.cpu().numpy()[first].astype(np.float64)
    return np.asarray(origin, np.float64) + verts * float(voxel), faces
