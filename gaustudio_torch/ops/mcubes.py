"""Isosurface extraction: marching tetrahedra on a dense grid (port of
gaustudio_tpu/ops/mcubes.py).

Each grid cube is split into 6 tetrahedra around its 0-7 diagonal, and each
tetrahedron's triangles come from a 16-case table. The triangles of a z-slab
of cubes are generated with torch ops on the field's device, which keeps only
the valid ones, in the (cube, tet, triangle) order of the JAX package's stable
compaction. The host then keys each vertex by its grid edge (int64),
dedups the keys, drops degenerate triangles and orients each triangle along
the field's gradient, as the JAX package does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gaustudio_torch.utils.observability import annotate, count

# corner c of a cube: offset (c&1, (c>>1)&1, (c>>2)&1)
_CUBE_OFFSETS = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int64)

# 6-tetrahedra decomposition around the 0-7 main diagonal
_TETS = np.array(
    [[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]],
    np.int64)


def _build_case_table():
    """16-case marching-tetrahedra table: up to 2 triangles, each vertex a
    (cornerA, cornerB) crossing edge of the tet; -1 padded."""
    table = -np.ones((16, 2, 3, 2), np.int64)

    def tri(*edges):
        return np.array(edges, np.int64)

    singles = {1: 0, 2: 1, 4: 2, 8: 3}
    for mask, v in singles.items():
        others = [o for o in range(4) if o != v]
        t = tri(*[(v, o) for o in others])
        table[mask, 0] = t
        table[15 ^ mask, 0] = t  # complement: same edges
    pairs = {3: (0, 1), 5: (0, 2), 9: (0, 3)}
    for mask, (a, b) in pairs.items():
        c, d = [o for o in range(4) if o not in (a, b)]
        # crossing edges (a,c), (a,d), (b,c), (b,d): a quad, as 2 triangles
        t0 = tri((a, c), (a, d), (b, d))
        t1 = tri((a, c), (b, d), (b, c))
        for m in (mask, 15 ^ mask):
            table[m, 0] = t0
            table[m, 1] = t1
    return table


_CASE_TABLE = _build_case_table()  # [16, 2, 3, 2]


def _slab_triangles(vals: torch.Tensor, weight: torch.Tensor, z0: int, iso: float,
                    min_weight: float):
    """The valid triangles of one z-slab of cubes.

    Args:
        vals, weight: [X, Y, dz+1] field and confidence of the slab.
        z0: global z index of the slab's first layer.

    Returns, for T valid triangles in (cube, tet, triangle) order:
        positions [3T, 3] float32 in grid units (global z), and the global
        integer grid coordinates [3T, 3] of each vertex's edge endpoints a, b.
    """
    device = vals.device
    X, Y, Z1 = vals.shape
    nx, ny, nz = X - 1, Y - 1, Z1 - 1
    offsets = torch.from_numpy(_CUBE_OFFSETS).to(device)
    tets = torch.from_numpy(_TETS).to(device)
    table = torch.from_numpy(_CASE_TABLE).to(device)

    # the 8 corner values / weights of every cube, cube index (cx*ny + cy)*nz + cz
    cv = torch.stack([vals[ox:ox + nx, oy:oy + ny, oz:oz + nz].reshape(-1)
                      for ox, oy, oz in _CUBE_OFFSETS.tolist()], dim=1)  # [C, 8]
    cw = torch.stack([weight[ox:ox + nx, oy:oy + ny, oz:oz + nz].reshape(-1)
                      for ox, oy, oz in _CUBE_OFFSETS.tolist()], dim=1)
    cube_ok = torch.amin(cw, dim=1) >= min_weight
    del cw
    bits = torch.tensor([1, 2, 4, 8], device=device)
    tmask = ((cv[:, tets] < iso).long() * bits).sum(-1)  # [C, 6]
    tri_valid = (table[:, :, 0, 0] >= 0)[tmask] & cube_ok[:, None, None]  # [C, 6, 2]
    flat = torch.nonzero(tri_valid.reshape(-1)).squeeze(1)  # ascending: the stable order
    cube = flat // 12
    tet = (flat // 2) % 6
    edges = table[tmask[cube, tet], flat % 2]  # [T, 3, 2] tet-corner indices
    corner_a = tets[tet[:, None], edges[..., 0]]  # [T, 3] cube-corner indices
    corner_b = tets[tet[:, None], edges[..., 1]]
    va = cv[cube[:, None], corner_a]
    vb = cv[cube[:, None], corner_b]
    base = torch.stack([cube // (ny * nz), (cube // nz) % ny, cube % nz], dim=-1)  # [T, 3]
    ga = base[:, None, :] + offsets[corner_a]  # [T, 3, 3] slab-local grid coordinates
    gb = base[:, None, :] + offsets[corner_b]
    pa, pb = ga.float(), gb.float()
    denom = vb - va
    t = torch.where(torch.abs(denom) > 1e-12, (iso - va) / denom, torch.full_like(va, 0.5))
    t = torch.clamp(t, 0.0, 1.0)
    pos = pa + t[..., None] * (pb - pa)
    pos[..., 2] += torch.tensor(float(z0), dtype=torch.float32, device=device)
    ga[..., 2] += z0
    gb[..., 2] += z0
    return pos.reshape(-1, 3), ga.reshape(-1, 3), gb.reshape(-1, 3)


def _gradient_at(values: np.ndarray, ci: np.ndarray) -> np.ndarray:
    """np.stack(np.gradient(values), -1)[ci[:, 0], ci[:, 1], ci[:, 2]],
    computed only at the indices ``ci`` (central differences inside,
    one-sided ones at the grid's faces), with np.gradient's operations."""
    g = np.empty((len(ci), 3), values.dtype)
    dims = values.shape
    for axis in range(3):
        i = ci[:, axis]
        lo, hi = ci.copy(), ci.copy()
        inner = (i > 0) & (i < dims[axis] - 1)
        lo[:, axis] = np.where(i > 0, i - 1, i)
        hi[:, axis] = np.where(i < dims[axis] - 1, i + 1, i)
        diff = values[hi[:, 0], hi[:, 1], hi[:, 2]] - values[lo[:, 0], lo[:, 1], lo[:, 2]]
        g[:, axis] = np.where(inner, diff / 2.0, diff)
    return g


def marching_tetrahedra(
    values,
    iso: float = 0.0,
    weight=None,
    min_weight: float = 0.0,
    origin=np.zeros(3),
    voxel_size: float = 1.0,
    slab: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices float32 [V, 3], faces int32 [F, 3]) of the ``iso`` surface
    of a dense field [X, Y, Z], a tensor (on its device) or an array (on the
    CPU). Cubes with a corner weight below ``min_weight`` emit nothing."""
    values = torch.as_tensor(values, dtype=torch.float32)
    weight = torch.ones_like(values) if weight is None else torch.as_tensor(
        weight, dtype=torch.float32).to(values.device)
    X, Y, Z = values.shape

    all_pos, all_keys = [], []
    with annotate("gs.mesh.march"):
        for z0 in range(0, Z - 1, slab):
            dz = min(slab, Z - 1 - z0)
            pos, ga, gb = _slab_triangles(values[:, :, z0:z0 + dz + 1],
                                          weight[:, :, z0:z0 + dz + 1], z0, iso, float(min_weight))
            if pos.shape[0] == 0:
                continue
            all_pos.append(pos.cpu().numpy())

            def flat64(g):
                g = g.cpu().numpy().astype(np.int64)
                return (g[:, 0] * Y + g[:, 1]) * np.int64(Z + 1) + g[:, 2]

            ia, ib = flat64(ga), flat64(gb)
            all_keys.append(np.stack([np.minimum(ia, ib), np.maximum(ia, ib)], axis=1))

    if not all_pos:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    with annotate("gs.mesh.dedup"):
        pos = np.concatenate(all_pos)  # [3T, 3]
        keys = np.concatenate(all_keys)
        key1d = keys[:, 0] * np.int64(X * Y * (Z + 1) + 1) + keys[:, 1]
        uniq, inverse = np.unique(key1d, return_inverse=True)
        verts = np.zeros((len(uniq), 3), np.float32)
        verts[inverse] = pos  # representatives (identical positions per edge)
        faces = inverse.reshape(-1, 3).astype(np.int32)

        # drop degenerate triangles (two vertices on the same edge)
        ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
              & (faces[:, 0] != faces[:, 2]))
        faces = faces[ok]

        # orient along the field gradient (positive side = outside for a TSDF)
        centroids = verts[faces].mean(axis=1)
        ci = np.clip(np.round(centroids).astype(int), 0, [X - 1, Y - 1, Z - 1])
        g = _gradient_at(values.cpu().numpy(), ci)
        e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
        e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
        flip = (np.cross(e1, e2) * g).sum(-1) < 0
        faces[flip] = faces[flip][:, [0, 2, 1]]

        verts_world = np.asarray(origin)[None, :] + verts * voxel_size
    count("gs.mesh.triangles", len(pos) // 3)
    count("gs.mesh.vertices", len(uniq))
    return verts_world.astype(np.float32), faces
