"""Triangle mesh rasterizer with a z-buffer, in torch ops (port of
gaustudio_tpu/ops/mesh_raster.py).

Pixel centres sit at integer coordinates. A triangle takes part only when
all three of its view-space z values exceed 1e-3. Each triangle expands into
(triangle, tile) candidates over the TILE x TILE tiles of its screen
bounding box, and each candidate tests its tile's pixels with the edge
functions of the JAX package (same formula order) and a perspective-correct
depth, 1 / sum(l_i / z_i). Three passes follow: a min z-buffer
(``scatter_reduce`` amin over pixel indices), the winner, which is the
smallest triangle id whose depth is at most zbuf * (1 + 1e-6), and the
winner's barycentrics, evaluated once a pixel. Empty pixels get depth 0, id
-1 and barycentrics 0.

The candidates are generated and tested in chunks sized from the device's
free memory, so no candidate is dropped: the JAX package keeps at most
``num_entries`` (1 << 20) of them and loses the triangles past that.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaustudio_torch.ops.gaussian import ndc2pix, transform_points

TILE = 8  # side of a candidate's tile, in pixels
TILE_PIXELS = TILE * TILE
_FAR = 3.0e38
_NO_TRIANGLE = 1 << 62
# bytes of float intermediates one pixel test of a candidate may take
_BYTES_PER_PIXEL_TEST = 96


class MeshFragments(NamedTuple):
    depth: torch.Tensor  # [H, W] view-space z (0 where empty)
    tri_id: torch.Tensor  # [H, W] int64 (-1 where empty)
    bary: torch.Tensor  # [H, W, 3]
    mask: torch.Tensor  # [H, W] bool


def _candidate_chunk(device: torch.device) -> int:
    """Candidates a chunk: an eighth of the card's free memory (at most 1
    GiB) of pixel-test intermediates; 64 MiB on the CPU."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = min(free // 8, 1 << 30)
    else:
        budget = 1 << 26
    return max(1, budget // (TILE_PIXELS * _BYTES_PER_PIXEL_TEST))


def _edge(ax, ay, bx, by):
    """Coefficients (a, b, c) of E(p) = (b - a) x (p - a) = a*px + b*py + c."""
    dx, dy = bx - ax, by - ay
    return dy, -dx, -(dy * ax - dx * ay)


def _pixel_test(tri: torch.Tensor, P, Z, px: torch.Tensor, py: torch.Tensor):
    """Edge functions of triangles ``tri`` [C] at pixels (px, py) [C, K]:
    (inside, l0, l1, perspective-correct depth), each [C, K]. ``P`` holds the
    faces' screen corners (x0, y0, x1, y1, x2, y2) and ``Z`` their view z."""
    x0, y0, x1, y1, x2, y2 = (c[tri][:, None] for c in P)
    z0, z1, z2 = (c[tri][:, None] for c in Z)
    a0, b0, c0 = _edge(x1, y1, x2, y2)
    a1, b1, c1 = _edge(x2, y2, x0, y0)
    a2, b2, c2 = _edge(x0, y0, x1, y1)
    e0 = a0 * px + b0 * py + c0
    e1 = a1 * px + b1 * py + c1
    e2 = a2 * px + b2 * py + c2
    area = e0 + e1 + e2
    ok_area = torch.abs(area) > 1e-12
    inside = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))) & ok_area
    safe = torch.where(ok_area, area, 1.0)
    l0 = e0 / safe
    l1 = e1 / safe
    l2 = 1.0 - l0 - l1
    invz = l0 / z0 + l1 / z1 + l2 / z2
    depth = 1.0 / torch.clamp_min(invz, 1e-9)
    return inside, l0, l1, depth


def rasterize_mesh(vertices, faces, viewmatrix, projmatrix, image_width: int,
                   image_height: int) -> MeshFragments:
    """Z-buffer rasterization of a triangle mesh on the vertices' device.

    Args:
        vertices: [V, 3] world positions (float32 tensor).
        faces: [F, 3] vertex indices.
        viewmatrix / projmatrix: the transposed world -> view and full
            projection matrices (``Camera.world_view_transform`` and
            ``full_proj_transform``).
    """
    device = vertices.device
    H, W = int(image_height), int(image_width)
    gx, gy = (W + TILE - 1) // TILE, (H + TILE - 1) // TILE
    vertices = vertices.to(torch.float32)
    viewmatrix = viewmatrix.to(device=device, dtype=torch.float32)
    projmatrix = projmatrix.to(device=device, dtype=torch.float32)
    f = torch.as_tensor(faces, device=device).long()

    hom = transform_points(vertices, projmatrix)
    ndc = hom[:, :3] / (hom[:, 3:4] + 1e-9)
    vx, vy = ndc2pix(ndc[:, 0], W), ndc2pix(ndc[:, 1], H)
    vz = transform_points(vertices, viewmatrix)[:, 2]
    P = (vx[f[:, 0]], vy[f[:, 0]], vx[f[:, 1]], vy[f[:, 1]], vx[f[:, 2]], vy[f[:, 2]])
    Z = (vz[f[:, 0]], vz[f[:, 1]], vz[f[:, 2]])
    in_front = (Z[0] > 1e-3) & (Z[1] > 1e-3) & (Z[2] > 1e-3)

    # each triangle's rectangle of tiles, and its candidates in a flat index
    xmin = torch.minimum(torch.minimum(P[0], P[2]), P[4])
    xmax = torch.maximum(torch.maximum(P[0], P[2]), P[4])
    ymin = torch.minimum(torch.minimum(P[1], P[3]), P[5])
    ymax = torch.maximum(torch.maximum(P[1], P[3]), P[5])
    tile_of = lambda v, n, end=0: torch.clamp(torch.floor(v / TILE) + end, 0, n).long()  # noqa: E731
    tx0, tx1 = tile_of(xmin, gx), tile_of(xmax, gx, 1)
    ty0, ty1 = tile_of(ymin, gy), tile_of(ymax, gy, 1)
    touched = torch.where(in_front, (tx1 - tx0) * (ty1 - ty0), 0)
    ends = torch.cumsum(touched, 0)
    total = int(ends[-1]) if len(ends) else 0
    chunk = _candidate_chunk(device)
    q = torch.arange(TILE_PIXELS, device=device)
    qx, qy = (q % TILE).float(), (q // TILE).float()

    def chunks():
        """(triangle [C], pixel x, y [C, TILE_PIXELS], pixel index, in image)."""
        for c0 in range(0, total, chunk):
            cid = torch.arange(c0, min(c0 + chunk, total), device=device)
            tri = torch.searchsorted(ends, cid, right=True)
            j = cid - (ends[tri] - touched[tri])
            rw = tx1[tri] - tx0[tri]
            px = (tx0[tri] + j % rw)[:, None].float() * TILE + qx
            py = (ty0[tri] + j // rw)[:, None].float() * TILE + qy
            in_img = (px < W) & (py < H)
            yield tri, px, py, py.long() * W + px.long(), in_img

    zbuf = torch.full((H * W,), _FAR, dtype=torch.float32, device=device)
    for tri, px, py, pix, in_img in chunks():
        inside, _, _, depth = _pixel_test(tri, P, Z, px, py)
        keep = inside & (depth > 1e-3) & in_img
        zbuf.scatter_reduce_(0, pix[keep], depth[keep], "amin")

    winner = torch.full((H * W,), _NO_TRIANGLE, dtype=torch.int64, device=device)
    for tri, px, py, pix, in_img in chunks():
        inside, _, _, depth = _pixel_test(tri, P, Z, px, py)
        won = inside & in_img & (depth > 1e-3)
        won &= depth <= zbuf[torch.where(in_img, pix, 0)] * (1 + 1e-6)
        winner.scatter_reduce_(0, pix[won], tri[:, None].expand_as(pix)[won], "amin")

    mask = zbuf < _FAR
    bary = torch.zeros((H * W, 3), dtype=torch.float32, device=device)
    pix = torch.nonzero(mask).squeeze(1)
    if len(pix):
        _, l0, l1, _ = _pixel_test(winner[pix], P, Z, (pix % W).float()[:, None],
                                   (pix // W).float()[:, None])
        bary[pix] = torch.cat([l0, l1, 1.0 - l0 - l1], dim=1)
    return MeshFragments(
        depth=torch.where(mask, zbuf, 0.0).reshape(H, W),
        tri_id=torch.where(mask, winner, -1).reshape(H, W),
        bary=bary.reshape(H, W, 3),
        mask=mask.reshape(H, W),
    )


def interpolate_attribute(frag: MeshFragments, faces, vertex_attr: torch.Tensor) -> torch.Tensor:
    """Barycentric interpolation of per-vertex attributes -> [H, W, C]
    (0 on empty pixels)."""
    f = torch.as_tensor(faces, device=vertex_attr.device).long()
    a = vertex_attr[f[torch.clamp_min(frag.tri_id, 0)]]  # [H, W, 3, C]
    out = torch.sum(frag.bary[..., None] * a, dim=-2)
    return torch.where(frag.mask[..., None], out, 0.0)


def face_normals(vertices: torch.Tensor, faces) -> torch.Tensor:
    """Unit normals [F, 3] of the faces, by the winding (v1 - v0) x (v2 - v0)."""
    f = torch.as_tensor(faces, device=vertices.device).long()
    n = torch.linalg.cross(vertices[f[:, 1]] - vertices[f[:, 0]],
                           vertices[f[:, 2]] - vertices[f[:, 0]], dim=-1)
    return n / torch.clamp_min(torch.linalg.norm(n, dim=1, keepdim=True), 1e-12)
