"""Plain float32 reference of the 3DGS and 2DGS rasterizers, forward and
gradients, written for this benchmark from the published algorithms.

It imports nothing of the program. It rebuilds from the raw attributes and
the camera dicts everything the program derives: the view and projection
matrices, the per-Gaussian projection (3DGS's EWA splat, or 2DGS's
tangent-plane homography), the SH colours, the (tile, depth)-sorted entries
and the front-to-back blend.

The blend works ``CHUNK`` in-tile ranks at a time over every live tile: the
transmittance of a chunk is one cumulative product seeded with the tile's T
(the sequential product the published rasterizers take), an entry is
applied while T after it stays >= 1e-4, and a tile stops once every pixel
has stopped. Gradients come from autograd through the same blend, tile
group by tile group (each group's chunks recomputed under autograd, then
its pixels' cotangents pulled back), so memory stays bounded at any size.

The conventions are the published rasterizers' and the program's alike:
alpha = min(0.99, opacity G), skipped below 1/255 (and, for 3DGS, where
the exponent is positive); the gradient ignores the 0.99 clamp, as the
3DGS backward does (``dL_dG = opacity * dL_dalpha``). 2DGS: a ray meets the
disk's plane by the two-plane construction; the screen-space fallback is
taken where it is closer, with the screen variance of the program's
reference package (2.0 px^2: ``rho2d = |d|^2 / 2``) and the centre depth;
an entry nearer than 0.2 is skipped. Both blends leave the background out;
the losses composite it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

TILE = 16
TILE_PIXELS = TILE * TILE
T_EPS = 1e-4
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
NEAR = 0.2
SURFEL_FILTER_VAR = 2.0
CHUNK = 32
# elements of a [tiles, CHUNK, 256] tensor that one group of tiles may hold
# over all its chunks while autograd keeps them
GRAD_GROUP_ELEMS = 48 << 20

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
      -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


# --- cameras ------------------------------------------------------------------


class View(NamedTuple):
    W: int
    H: int
    tanfovx: float
    tanfovy: float
    viewmatrix: torch.Tensor  # [4, 4] transposed world -> view (row vectors)
    projmatrix: torch.Tensor  # [4, 4] transposed world -> clip
    campos: torch.Tensor  # [3]
    fx: float
    fy: float


def view(cam: dict, device, znear: float = 0.1, zfar: float = 100.0, scale: int = 1,
         dtype=torch.float32) -> View:
    """The matrices of a cameras.json entry, as getWorld2View2 and
    getProjectionMatrix build them (float64, then float32, then ``dtype``);
    ``scale`` downsamples the image (the field of view stays)."""
    W0, H0 = int(cam["width"]), int(cam["height"])
    W, H = (round(W0 / scale), round(H0 / scale)) if scale != 1 else (W0, H0)
    fovx = 2.0 * math.atan(W0 / (2.0 * cam["fx"]))
    fovy = 2.0 * math.atan(H0 / (2.0 * cam["fy"]))
    c2w = np.eye(4)
    c2w[:3, :3] = np.asarray(cam["rotation"], np.float64)
    c2w[:3, 3] = np.asarray(cam["position"], np.float64)
    w2v = np.linalg.inv(c2w)
    tx, ty = math.tan(fovx / 2), math.tan(fovy / 2)
    P = np.zeros((4, 4))
    P[0, 0] = 1.0 / tx
    P[1, 1] = 1.0 / ty
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    wv = np.float32(w2v).T
    full = (wv @ np.float32(P).T).astype(np.float32)
    as_t = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(device=device, dtype=dtype)
    return View(W, H, tx, ty, as_t(wv), as_t(full), as_t(c2w[:3, 3]),
                W / (2.0 * tx), H / (2.0 * ty))


def _hom(p, m):
    """(p, 1) @ m for points [N, 3] and a [4, 4] matrix."""
    return p @ m[:3] + m[3]


# --- SH ---------------------------------------------------------------------------


def sh_colour(f_dc, f_rest, xyz, campos):
    """RGB of SH degree 3 (Inria layout: f_rest is channel-major [N, 3, 15]),
    + 0.5 and clamped at 0."""
    n = xyz.shape[0]
    sh = torch.cat([f_dc.reshape(n, 1, 3), f_rest.reshape(n, 3, 15).transpose(1, 2)], 1)
    d = xyz - campos
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    basis = [torch.full_like(x, C0), -C1 * y, C1 * z, -C1 * x,
             C2[0] * xy, C2[1] * yz, C2[2] * (2 * zz - xx - yy), C2[3] * xz, C2[4] * (xx - yy),
             C3[0] * y * (3 * xx - yy), C3[1] * xy * z, C3[2] * y * (4 * zz - xx - yy),
             C3[3] * z * (2 * zz - 3 * xx - 3 * yy), C3[4] * x * (4 * zz - xx - yy),
             C3[5] * z * (xx - yy), C3[6] * x * (xx - 3 * yy)]
    rgb = sum(b * sh[:, k] for k, b in enumerate(basis)) + 0.5
    return torch.clamp_min(rgb, 0.0)


# --- per-Gaussian projection -----------------------------------------------------


def _tile_rect(mean2d, rx, ry, gx, gy):
    lo = torch.stack([torch.clamp(torch.floor((mean2d[:, 0] - rx) / TILE), 0, gx),
                      torch.clamp(torch.floor((mean2d[:, 1] - ry) / TILE), 0, gy)], -1)
    hi = torch.stack([torch.clamp(torch.floor((mean2d[:, 0] + rx + TILE - 1) / TILE), 0, gx),
                      torch.clamp(torch.floor((mean2d[:, 1] + ry + TILE - 1) / TILE), 0, gy)], -1)
    return lo.long(), hi.long()


class Splats(NamedTuple):
    """Per-Gaussian screen quantities; ``rect_lo``/``rect_hi`` give the
    tiles of each (empty for a culled one), ``depth`` the sort key."""
    depth: torch.Tensor
    rect_lo: torch.Tensor
    rect_hi: torch.Tensor
    attrs: Dict[str, torch.Tensor]  # what the hit function reads per Gaussian


def project_3dgs(p: dict, v: View) -> Splats:
    """3DGS preprocess of raw attributes: EWA covariance (1.3 tan-fov clamp,
    + 0.3 low-pass), conic, 3-sigma radius, SH colour."""
    xyz = p["xyz"]
    gx, gy = (v.W + TILE - 1) // TILE, (v.H + TILE - 1) // TILE
    t = _hom(xyz, v.viewmatrix)[:, :3]
    depth = t[:, 2]
    ph = _hom(xyz, v.projmatrix)
    pw = 1.0 / (ph[:, 3] + 1e-7)
    mean2d = torch.stack([((ph[:, 0] * pw + 1.0) * v.W - 1.0) * 0.5,
                          ((ph[:, 1] * pw + 1.0) * v.H - 1.0) * 0.5], -1)
    s = torch.exp(p["scale"])
    q = p["rot"] / torch.linalg.vector_norm(p["rot"], dim=-1, keepdim=True)
    r, x, y, z = q.unbind(-1)
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)], -2)
    M = R * s[:, None, :]
    cov3 = M @ M.transpose(1, 2)
    near = torch.full_like(depth, NEAR)
    tz = torch.where(depth.abs() < NEAR, torch.where(depth >= 0, near, -near), depth)
    limx, limy = 1.3 * v.tanfovx, 1.3 * v.tanfovy
    tx = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[:, 1] / tz, -limy, limy) * tz
    zeros = torch.zeros_like(tz)
    J = torch.stack([torch.stack([v.fx / tz, zeros, -v.fx * tx / (tz * tz)], -1),
                     torch.stack([zeros, v.fy / tz, -v.fy * ty / (tz * tz)], -1)], -2)
    Wr = v.viewmatrix[:3, :3].T
    T = J @ Wr
    cov2 = T @ cov3 @ T.transpose(1, 2)
    a = cov2[:, 0, 0] + 0.3
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + 0.3
    det = a * c - b * b
    ok = det > 0
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    opacity = torch.sigmoid(p["opacity"][:, 0])
    with torch.no_grad():
        # the rect: the 3-sigma square cut to the bbox of the ellipse where
        # opacity G >= 1/255, sqrt(2 ln(255 op)) sigma, as the program's
        # reference package bins (see PERF.md on where this departs from 3DGS)
        radius = torch.ceil(3.0 * torch.sqrt(lam))
        support = torch.sqrt(torch.clamp_min(2.0 * torch.log(255.0 * torch.clamp_min(
            opacity, 1e-12)), 0.0) + 1e-12)
        lit = opacity > ALPHA_MIN
        bx = torch.where(lit, torch.ceil(torch.minimum(
            radius, support * torch.sqrt(torch.clamp_min(a, 0.0) + 1e-12))), 0.0)
        by = torch.where(lit, torch.ceil(torch.minimum(
            radius, support * torch.sqrt(torch.clamp_min(c, 0.0) + 1e-12))), 0.0)
        lo, hi = _tile_rect(mean2d, bx, by, gx, gy)
        keep = (depth > NEAR) & ok
        hi = torch.where(keep[:, None], hi, lo)
    colour = sh_colour(p["f_dc"], p["f_rest"], xyz, v.campos)
    return Splats(depth, lo, hi, {"mean2d": mean2d, "conic": conic, "opacity": opacity,
                                  "colour": colour, "depth": depth})


def project_2dgs(p: dict, v: View) -> Splats:
    """2DGS preprocess: the disk's tangent frame to a pixel homography M
    (rows x, y, w over (u, v, 1)), its view-depth coefficients, its view
    normal, SH colour; the tile rect from 3x its projected half-axes."""
    xyz = p["xyz"]
    W, H = v.W, v.H
    gx, gy = (W + TILE - 1) // TILE, (H + TILE - 1) // TILE
    q = p["rot"] / torch.linalg.vector_norm(p["rot"], dim=-1, keepdim=True)
    r, x, y, z = q.unbind(-1)
    axis_u = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y + r * z), 2 * (x * z - r * y)], -1)
    axis_v = torch.stack([2 * (x * y - r * z), 1 - 2 * (x * x + z * z), 2 * (y * z + r * x)], -1)
    normal = torch.stack([2 * (x * z + r * y), 2 * (y * z - r * x), 1 - 2 * (x * x + y * y)], -1)
    s = torch.exp(p["scale"])
    tu, tv = axis_u * s[:, :1], axis_v * s[:, 1:2]
    depth = _hom(xyz, v.viewmatrix)[:, 2]
    Su, Sv, Sp = tu @ v.projmatrix[:3], tv @ v.projmatrix[:3], _hom(xyz, v.projmatrix)

    def rows(S):
        return (0.5 * W * (S[:, 0] + S[:, 3]) - 0.5 * S[:, 3],
                0.5 * H * (S[:, 1] + S[:, 3]) - 0.5 * S[:, 3], S[:, 3])

    (xu, yu, wu), (xv, yv, wv), (xp, yp, wp) = rows(Su), rows(Sv), rows(Sp)
    M9 = torch.stack([xu, xv, xp, yu, yv, yp, wu, wv, wp], -1)
    Rv = v.viewmatrix[:3, :3]
    Dk = torch.stack([(tu @ Rv)[:, 2], (tv @ Rv)[:, 2], depth], -1)
    normal_view = normal @ Rv
    wc = wp + 1e-7
    mean2d = torch.stack([xp / wc, yp / wc], -1)
    with torch.no_grad():
        cx, cy = mean2d[:, 0], mean2d[:, 1]

        def extent(mx, my, mw):
            ex = (xp + mx) / (wc + mw) - cx
            ey = (yp + my) / (wc + mw) - cy
            return torch.sqrt(ex * ex + ey * ey)

        radius = torch.ceil(3.0 * torch.clamp_min(torch.maximum(extent(xu, yu, wu),
                                                                  extent(xv, yv, wv)), 2.0))
        lo, hi = _tile_rect(mean2d, radius, radius, gx, gy)
        keep = (depth > NEAR) & torch.isfinite(radius)
        hi = torch.where(keep[:, None], hi, lo)
    colour = sh_colour(p["f_dc"], p["f_rest"], xyz, v.campos)
    return Splats(depth, lo, hi, {"M9": M9, "Dk": Dk, "mean2d": mean2d,
                                  "opacity": torch.sigmoid(p["opacity"][:, 0]),
                                  "colour": colour, "normal": normal_view})


# --- binning ------------------------------------------------------------------------


class Entries(NamedTuple):
    point_list: torch.Tensor  # [L] Gaussian of each entry, (tile, depth)-sorted
    ranges: torch.Tensor  # [T, 2] [start, end) of each tile
    grid_x: int
    grid_y: int


def bin_entries(sp: Splats, W: int, H: int) -> Entries:
    """One entry per (Gaussian, tile of its rect), sorted by tile, then by
    depth, ties in Gaussian order."""
    gx, gy = (W + TILE - 1) // TILE, (H + TILE - 1) // TILE
    wh = (sp.rect_hi - sp.rect_lo).clamp_min(0)
    count = wh[:, 0] * wh[:, 1]
    g = torch.repeat_interleave(torch.arange(count.shape[0], device=count.device), count)
    first = torch.cumsum(count, 0) - count
    j = torch.arange(g.shape[0], device=g.device) - first[g]
    w = wh[g, 0].clamp_min(1)
    tile = (sp.rect_lo[g, 1] + j // w) * gx + sp.rect_lo[g, 0] + j % w
    del j, w, first
    # depth order within a tile: sort by depth first, then stably by tile
    d = sp.depth.detach()[g]
    by_depth = torch.sort(d, stable=True).indices
    by_tile = torch.sort(tile[by_depth], stable=True).indices
    order = by_depth[by_tile]
    point_list = g[order]
    tiles_sorted = tile[order]
    bounds = torch.searchsorted(tiles_sorted, torch.arange(gx * gy + 1, device=g.device))
    ranges = torch.stack([bounds[:-1], bounds[1:]], -1)
    return Entries(point_list, ranges, gx, gy)


# --- hits -------------------------------------------------------------------------------


def _clamp_alpha(raw):
    """min(raw, 0.99) with the gradient of raw (the 3DGS backward's)."""
    return raw - torch.clamp_min(raw - ALPHA_MAX, 0.0).detach()


def hit_3dgs(a: dict) -> Callable:
    mean2d, conic, opacity, colour = a["mean2d"], a["conic"], a["opacity"], a["colour"]
    depth = a["depth"]

    def hit(g, px, py):
        dx = mean2d[g, 0][..., None] - px
        dy = mean2d[g, 1][..., None] - py
        power = -0.5 * (conic[g, 0][..., None] * dx * dx + conic[g, 2][..., None] * dy * dy) \
            - conic[g, 1][..., None] * dx * dy
        alpha = _clamp_alpha(opacity[g][..., None] * torch.exp(power))
        alpha = torch.where((power > 0) | (alpha < ALPHA_MIN), 0.0, alpha)
        return alpha, {"colour": colour[g][:, :, None, :]}, depth[g][..., None]

    return hit


def hit_2dgs(a: dict) -> Callable:
    M9, Dk, mean2d, opacity = a["M9"], a["Dk"], a["mean2d"], a["opacity"]
    colour, normal = a["colour"], a["normal"]

    def hit(g, px, py):
        m = M9[g]
        col = lambda i: m[..., i, None]  # noqa: E731
        hu = [px * col(6 + k) - col(k) for k in range(3)]
        hv = [py * col(6 + k) - col(3 + k) for k in range(3)]
        s0 = hu[1] * hv[2] - hu[2] * hv[1]
        s1 = hu[2] * hv[0] - hu[0] * hv[2]
        s2 = hu[0] * hv[1] - hu[1] * hv[0]
        s2 = torch.where(s2.abs() < 1e-9, torch.full_like(s2, 1e-9), s2)
        u, v = s0 / s2, s1 / s2
        rho3d = u * u + v * v
        dx = mean2d[g, 0][..., None] - px
        dy = mean2d[g, 1][..., None] - py
        rho2d = (dx * dx + dy * dy) / SURFEL_FILTER_VAR
        use3d = rho3d <= rho2d
        alpha = _clamp_alpha(opacity[g][..., None] * torch.exp(-0.5 * torch.where(use3d, rho3d,
                                                                                   rho2d)))
        dk = Dk[g]
        depth = torch.where(use3d, dk[..., 0, None] * u + dk[..., 1, None] * v,
                            torch.zeros_like(u)) + dk[..., 2, None]
        alpha = torch.where((depth <= NEAR) | (alpha < ALPHA_MIN), 0.0, alpha)
        return alpha, {"colour": colour[g][:, :, None, :], "normal": normal[g][:, :, None, :],
                       "depth": depth[..., None], "depth2": (depth * depth)[..., None]}, depth

    return hit


# --- the blend ------------------------------------------------------------------------


def tile_pixels(tiles, grid_x):
    q = torch.arange(TILE_PIXELS, device=tiles.device)
    return (((tiles % grid_x) * TILE)[:, None] + q % TILE,
            ((tiles // grid_x) * TILE)[:, None] + q // TILE)


def _blend(hit, e: Entries, tiles, W, H, widths: dict, dt, chunks=None, median=False,
           contrib=False):
    """Front-to-back blend of the entries of ``tiles``: returns (weighted sums
    {name: [k, 256, width]}, final T [k, 256], chunks walked [k], per-pixel
    extras {"median": depth [k, 256] with ``median``, "n_contrib": the rank
    + 1 of the last entry applied [k, 256] with ``contrib``}). With
    ``chunks`` the walk replays a schedule."""
    device = e.point_list.device
    k = tiles.shape[0]
    start = e.ranges[tiles, 0]
    run = e.ranges[tiles, 1] - start
    px, py = tile_pixels(tiles, e.grid_x)
    done = (px >= W) | (py >= H)
    pxf, pyf = px.to(dt)[:, None, :], py.to(dt)[:, None, :]
    last = max(e.point_list.shape[0] - 1, 0)
    T = torch.ones((k, TILE_PIXELS), device=device, dtype=dt)
    sums = {n: torch.zeros((k, TILE_PIXELS, w), device=device, dtype=dt)
            for n, w in widths.items()}
    walked = torch.zeros(k, dtype=torch.long, device=device)
    med = torch.zeros((k, TILE_PIXELS), device=device, dtype=dt) if median else None
    nc = torch.zeros((k, TILE_PIXELS), device=device, dtype=torch.long) if contrib else None
    limit = int(chunks.max()) if chunks is not None and k else \
        (int((run.max() + CHUNK - 1) // CHUNK) if k else 0)
    ranks = torch.arange(CHUNK, device=device)
    for c in range(limit):
        if chunks is not None:
            act = torch.nonzero(chunks > c).squeeze(1)
        else:
            act = torch.nonzero((run > c * CHUNK) & ~done.all(1)).squeeze(1)
        if act.numel() == 0:
            break
        j = c * CHUNK + ranks
        ok = j[None, :] < run[act, None]
        g = e.point_list[torch.clamp(start[act, None] + j, max=last)]
        alpha, pay, depth = hit(g, pxf[act], pyf[act])
        live = ok[:, :, None] & (alpha > 0) & ~done[act][:, None, :]
        alpha = torch.where(live, alpha, 0.0)
        Tc = torch.cumprod(torch.cat([T[act][:, None, :], 1.0 - alpha], 1), 1)
        T_before, T_after = Tc[:, :-1], Tc[:, 1:]
        applied = live & (T_after >= T_EPS)
        w = torch.where(applied, alpha * T_before, 0.0)
        for n, v in pay.items():
            sums[n] = sums[n].index_add(0, act, (w[..., None] * v).sum(1))
        T_next = torch.minimum(T[act], torch.where(applied, T_after, 2.0).amin(1))
        T = T.index_copy(0, act, T_next)
        stopped = (live & (T_after < T_EPS)).any(1)
        done = done.index_copy(0, act, done[act] | stopped)
        walked[act] = c + 1
        if median:
            cross = applied & (T_before > 0.5) & (T_after < 0.5)
            m = torch.where(cross, depth.detach(), 0.0).sum(1)
            med[act] = torch.where(cross.any(1), m, med[act])
        if contrib:
            rank = torch.where(applied, (j + 1)[None, :, None], 0).amax(1)
            nc[act] = torch.maximum(nc[act], rank)
    extra = {}
    if median:
        extra["median"] = med
    if contrib:
        extra["n_contrib"] = nc
    return sums, T, walked, extra


def _to_image(x, e: Entries, W, H):
    """[T, 256, ...] tile-major -> [H, W, ...]."""
    trail = tuple(x.shape[2:])
    img = x.reshape((e.grid_y, e.grid_x, TILE, TILE) + trail).transpose(1, 2)
    return img.reshape((e.grid_y * TILE, e.grid_x * TILE) + trail)[:H, :W]


WIDTHS = {"3dgs": {"colour": 3}, "2dgs": {"colour": 3, "normal": 3, "depth": 1, "depth2": 1}}


def render(model: str, sp: Splats, e: Entries, W: int, H: int, median: bool = False,
           contrib: bool = False):
    """Forward render, no autograd: {name: [H, W, width]}, "T": [H, W]
    (and "median" [H, W] with ``median``, "n_contrib" [H, W] with
    ``contrib``), plus "_chunks" [T], the schedule of a later
    :func:`pullback`."""
    hit = (hit_2dgs if model == "2dgs" else hit_3dgs)({k: v.detach() for k, v in sp.attrs.items()})
    tiles = torch.arange(e.grid_x * e.grid_y, device=e.point_list.device)
    with torch.no_grad():
        sums, T, walked, extra = _blend(hit, e, tiles, W, H, WIDTHS[model],
                                        sp.attrs["opacity"].dtype, median=median,
                                        contrib=contrib)
    out = {n: _to_image(v, e, W, H) for n, v in sums.items()}
    out["T"] = _to_image(T, e, W, H)
    out.update({n: _to_image(v, e, W, H) for n, v in extra.items()})
    out["_chunks"] = walked
    return out


def pullback(model: str, sp: Splats, e: Entries, W: int, H: int, chunks, cotangents: dict):
    """Gradients of sum(out * cotangent) in the per-Gaussian attributes
    ``sp.attrs``: each tile group's blend recomputed under autograd with the
    forward's schedule. Returns {attr: grad}."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in sp.attrs.items()}
    hit = (hit_2dgs if model == "2dgs" else hit_3dgs)(leaves)
    ct = {n: _tiles_of(c, e) for n, c in cotangents.items()}
    order = torch.argsort(chunks, descending=True)
    cost = (chunks[order] * CHUNK * TILE_PIXELS).cpu().numpy()
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    i, n = 0, order.shape[0]
    while i < n and cost[i] > 0:
        j, total = i, 0
        while j < n and cost[j] > 0 and (j == i or total + cost[j] <= GRAD_GROUP_ELEMS):
            total += cost[j]
            j += 1
        group = order[i:j]
        sums, T, _, _ = _blend(hit, e, group, W, H, WIDTHS[model], sp.attrs["opacity"].dtype,
                               chunks=chunks[group])
        outs = dict(sums, T=T[..., None])
        loss = sum((outs[n_] * ct[n_][group]).sum() for n_ in ct)
        got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        for (k, _), gk in zip(leaves.items(), got):
            if gk is not None:
                grads[k] += gk
        i = j
    return grads


def _tiles_of(img, e: Entries):
    """[H, W, c] -> [T, 256, c] tile-major, zero past the edge."""
    H, W = img.shape[:2]
    full = img.new_zeros((e.grid_y * TILE, e.grid_x * TILE) + tuple(img.shape[2:]))
    full[:H, :W] = img
    full = full.reshape((e.grid_y, TILE, e.grid_x, TILE) + tuple(img.shape[2:])).transpose(1, 2)
    return full.reshape((e.grid_y * e.grid_x, TILE_PIXELS) + tuple(img.shape[2:]))
