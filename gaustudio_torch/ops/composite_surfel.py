"""Surfel tile compositing: K5 :func:`render_surfel_tiles`, K6
:func:`render_surfel_tiles_backward`, their plain PyTorch versions, and
:func:`composite_surfel`, the autograd Function that joins the two (the
counterpart of gaustudio_tpu/ops/rasterize_surfel.py composite_surfel_fast).

K5 (csrc/composite_surfel.cu) replaces gaustudio_tpu/ops/
rasterize_surfel_pallas.py _surfel_kernel (B7). K6 (csrc/
composite_surfel_bwd.cu) replaces gaustudio_tpu/ops/
rasterize_surfel_pallas_bwd.py _surfel_bwd_kernel (B8) and the per-Gaussian
reduction of reduce_surfel_entry_grads (B5). Both read each tile's run in
place through the ranges of binning, as K3 and K4 do.

The plain versions are the golden composite_surfel of the JAX package,
written as loops over the in-tile rank of the sorted entries, vectorised
over every tile and pixel. The rules:

* the two-plane intersection and alpha of :func:`_surfel_hit`, one rounding
  per tensor op, as the kernels' unfused ``gs_surfel_hit`` does;
* an entry with alpha == 0 is skipped; an entry is applied iff
  T * (1 - alpha) >= 1e-4, and the first that is not ends the pixel's walk;
* the median depth / weight / id is taken at the applied entry where T
  crosses 0.5 (defaults 0); ``n_contrib`` is 1 + the in-tile position of
  the last applied entry; m1 is the depth sum.

The backward is B8's: payload col.dC + depth dDs + depth^2 dm2 + nrm.dN +
dA, no background term and no gate at the 0.99 clamp.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaustudio_torch.ops.composite import (
    _live_tiles,
    _tile_pixels,
    image_to_tiles,
    tiles_to_image,
)
from gaustudio_torch.utils import kernels
from gaustudio_torch.utils.observability import annotate

_ALPHA_MAX = 0.99
_ALPHA_MIN = 1.0 / 255.0
_TERM_EPS = 1e-4
_FILTER_2D_VAR = 2.0  # screen-space low-pass variance (the 2DGS 2D filter)
NUM_GRADS = 21  # M 9, Dk 3, opacity, colour 3, normal 3, centre 2


class SurfelCompositeOut(NamedTuple):
    color: torch.Tensor  # [3, H, W]
    depth_sum: torch.Tensor  # [1, H, W] sum w depth (= m1)
    normal: torch.Tensor  # [3, H, W] view space
    median_depth: torch.Tensor  # [1, H, W]
    median_weight: torch.Tensor  # [1, H, W]
    median_id: torch.Tensor  # [1, H, W] int32
    final_T: torch.Tensor  # [H, W]
    dist_m2: torch.Tensor  # [1, H, W] sum w depth^2
    n_contrib: torch.Tensor  # [H, W] int32


class SurfelGrads(NamedTuple):
    M: torch.Tensor  # [N, 3, 3]
    Dk: torch.Tensor  # [N, 3]
    mean2d: torch.Tensor  # [N, 2]
    opacity: torch.Tensor  # [N]
    colors: torch.Tensor  # [N, 3]
    normal: torch.Tensor  # [N, 3]


class _Hit(NamedTuple):
    hu: list
    hv: list
    sz: torch.Tensor
    guarded: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    dx: torch.Tensor  # centre - pixel
    dy: torch.Tensor
    use3d: torch.Tensor
    G: torch.Tensor
    alpha: torch.Tensor  # 0: skipped at this pixel
    depth: torch.Tensor


def _surfel_hit(m, dk, c, op, px, py) -> _Hit:
    """Entries with rows m [k, 9] (Mx, My, Mw), dk [k, 3], centre c [k, 2] and
    opacity op [k] against the pixels px, py [k, 256] of their tiles."""
    col = lambda x, i: x[:, i:i + 1]  # noqa: E731
    hu = [px * col(m, 6 + k) - col(m, k) for k in range(3)]
    hv = [py * col(m, 6 + k) - col(m, 3 + k) for k in range(3)]
    s0 = hu[1] * hv[2] - hu[2] * hv[1]
    s1 = hu[2] * hv[0] - hu[0] * hv[2]
    s2 = hu[0] * hv[1] - hu[1] * hv[0]
    guarded = torch.abs(s2) < 1e-9
    sz = torch.where(guarded, 1e-9, s2)
    u = s0 / sz
    v = s1 / sz
    rho3d = u * u + v * v
    dx = col(c, 0) - px
    dy = col(c, 1) - py
    rho2d = (dx * dx + dy * dy) / _FILTER_2D_VAR
    use3d = rho3d <= rho2d
    G = torch.exp(-0.5 * torch.where(use3d, rho3d, rho2d))
    alpha = torch.clamp_max(op[:, None] * G, _ALPHA_MAX)
    depth = torch.where(use3d, col(dk, 0) * u + col(dk, 1) * v + col(dk, 2), col(dk, 2))
    alpha = torch.where((depth <= 0.2) | (alpha < _ALPHA_MIN), 0.0, alpha)
    return _Hit(hu, hv, sz, guarded, u, v, dx, dy, use3d, G, alpha, depth)


def render_surfel_tiles_plain(ranges, point_list, M, Dk, mean2d, opacity, colors, normals,
                              grid_x: int, grid_y: int, W: int, H: int) -> SurfelCompositeOut:
    """Plain version of K5, same inputs and outputs."""
    device = opacity.device
    m = M.reshape(-1, 9)
    num_tiles = grid_x * grid_y
    order, live = _live_tiles((ranges[:, 1] - ranges[:, 0]).to(torch.int64))
    starts = ranges[order, 0].to(torch.int64)
    px, py = _tile_pixels(order, grid_x)
    done = (px >= W) | (py >= H)  # outside pixels never composite
    px, py = px.to(torch.float32), py.to(torch.float32)

    shape = (num_tiles, 256)
    zeros = lambda *trail: torch.zeros(shape + trail, dtype=torch.float32, device=device)  # noqa: E731
    T = torch.ones(shape, dtype=torch.float32, device=device)
    C, Nrm = zeros(3), zeros(3)
    D, M2, med_d, med_w = zeros(), zeros(), zeros(), zeros()
    med_i = torch.zeros(shape, dtype=torch.int32, device=device)
    n_con = torch.zeros(shape, dtype=torch.int32, device=device)

    for r in range(len(live)):
        k = int(live[r])
        g = point_list[starts[:k] + r].to(torch.int64)
        h = _surfel_hit(m[g], Dk[g], mean2d[g], opacity[g], px[:k], py[:k])
        Tk = T[:k]
        test_T = Tk * (1.0 - h.alpha)
        live_px = ~done[:k] & (h.alpha > 0.0)
        stop = live_px & (test_T < _TERM_EPS)
        apply = live_px & ~stop
        done[:k] |= stop
        w = torch.where(apply, h.alpha * Tk, 0.0)
        C[:k] += w[..., None] * colors[g][:, None, :]
        Nrm[:k] += w[..., None] * normals[g][:, None, :]
        D[:k] += w * h.depth
        M2[:k] += h.depth * h.depth * w
        cross = apply & (Tk > 0.5) & (test_T < 0.5)
        med_d[:k] = torch.where(cross, h.depth, med_d[:k])
        med_w[:k] = torch.where(cross, w, med_w[:k])
        med_i[:k] = torch.where(cross, g.to(torch.int32)[:, None], med_i[:k])
        n_con[:k] = torch.where(apply, r + 1, n_con[:k])
        T[:k] = torch.where(apply, test_T, Tk)

    inv = torch.empty_like(order)
    inv[order] = torch.arange(num_tiles, device=device)
    img = lambda x: tiles_to_image(x[inv], grid_x, grid_y, H, W)  # noqa: E731
    return SurfelCompositeOut(
        color=img(C).permute(2, 0, 1).contiguous(), depth_sum=img(D)[None],
        normal=img(Nrm).permute(2, 0, 1).contiguous(), median_depth=img(med_d)[None],
        median_weight=img(med_w)[None], median_id=img(med_i)[None], final_T=img(T),
        dist_m2=img(M2)[None], n_contrib=img(n_con))


def _entry_inputs(name, ranges, point_list, M, Dk, mean2d, opacity, colors, normals, num_tiles):
    """The kernels' per-entry inputs as contiguous int32 / float32 CUDA tensors."""
    ins = (ranges.int().contiguous(), point_list.int().contiguous(),
           M.float().reshape(-1, 9).contiguous(), Dk.float().contiguous(),
           mean2d.float().contiguous(), opacity.float().contiguous(),
           colors.float().contiguous(), normals.float().contiguous())
    kernels.require_cuda(name, *ins)
    if ins[0].shape != (num_tiles, 2):
        raise ValueError(f"{name}: ranges {tuple(ins[0].shape)} != ({num_tiles}, 2)")
    n = ins[5].numel()
    for field, t, width in zip(("M", "Dk", "mean2d", "colors", "normals"),
                               ins[2:5] + ins[6:], (9, 3, 2, 3, 3)):
        if t.numel() != n * width:
            raise ValueError(f"{name}: {field} must hold {n} x {width} values, "
                             f"got shape {tuple(t.shape)}")
    return ins


def render_surfel_tiles(ranges, point_list, M, Dk, mean2d, opacity, colors, normals,
                        grid_x: int, grid_y: int, W: int, H: int) -> SurfelCompositeOut:
    """K5: composite every tile of surfels; the kernel for CUDA tensors."""
    if not opacity.is_cuda:
        return render_surfel_tiles_plain(ranges, point_list, M, Dk, mean2d, opacity, colors,
                                         normals, grid_x, grid_y, W, H)
    ins = _entry_inputs("render_surfel_tiles", ranges, point_list, M, Dk, mean2d, opacity,
                        colors, normals, grid_x * grid_y)
    f32 = dict(dtype=torch.float32, device=opacity.device)
    i32 = dict(dtype=torch.int32, device=opacity.device)
    out = SurfelCompositeOut(
        color=torch.empty((3, H, W), **f32), depth_sum=torch.empty((1, H, W), **f32),
        normal=torch.empty((3, H, W), **f32), median_depth=torch.empty((1, H, W), **f32),
        median_weight=torch.empty((1, H, W), **f32), median_id=torch.empty((1, H, W), **i32),
        final_T=torch.empty((H, W), **f32), dist_m2=torch.empty((1, H, W), **f32),
        n_contrib=torch.empty((H, W), **i32))
    kernels.check(kernels.load().gs_render_surfel_tiles(
        grid_x, grid_y, W, H, *(t.data_ptr() for t in ins), *(t.data_ptr() for t in out),
        kernels.stream()), "gs_render_surfel_tiles")
    render_surfel_tiles.launches += 1
    return out


render_surfel_tiles.launches = 0


def render_surfel_tiles_backward_plain(
        ranges, point_list, M, Dk, mean2d, opacity, colors, normals, final_T, n_contrib,
        dL_dcolor, dL_ddepth_sum, dL_dm2, dL_dnormal, dL_dfinal_T, dL_dmedian,
        grid_x: int, grid_y: int, W: int, H: int) -> SurfelGrads:
    """Plain version of K6: B8's reverse walk and B5's per-Gaussian sums.

    ``final_T`` and ``n_contrib`` [H, W] are the forward's; the cotangents are
    dL/dcolor and dL/dnormal [3, H, W] and dL/d(depth sum + m1), dL/dm2,
    dL/dfinal_T, dL/dmedian_depth, each [H, W] or [1, H, W]. Each pixel walks
    its positions below ``n_contrib`` backwards, rebuilds T by division and
    keeps the suffix sum of w * payload of the entries behind; per-Gaussian
    sums go through ``index_add_``.
    """
    device = opacity.device
    n = opacity.shape[0]
    m = M.reshape(n, 9)
    tiles = lambda x: image_to_tiles(x, grid_x, grid_y)  # noqa: E731
    nc = tiles(n_contrib.reshape(H, W)).to(torch.int64)
    order, live = _live_tiles(nc.max(dim=1).values)
    starts = ranges[order, 0].to(torch.int64)
    px, py = (p.to(torch.float32) for p in _tile_pixels(order, grid_x))
    nc = nc[order]
    per_pixel = lambda x: tiles(x.reshape(H, W))[order]  # noqa: E731
    per_pixel3 = lambda x: tiles(x.reshape(3, H, W).permute(1, 2, 0))[order]  # noqa: E731
    T = per_pixel(final_T).clone()
    dC, dN = per_pixel3(dL_dcolor), per_pixel3(dL_dnormal)
    dDs, dM2, dMed = per_pixel(dL_ddepth_sum), per_pixel(dL_dm2), per_pixel(dL_dmedian)
    dA = -per_pixel(dL_dfinal_T)  # alpha = 1 - T_final

    Sq = torch.zeros_like(T)  # suffix sums of w * payload
    acc = torch.zeros((n, NUM_GRADS), dtype=torch.float32, device=device)
    for r in range(len(live) - 1, -1, -1):
        k = int(live[r])
        g = point_list[starts[:k] + r].to(torch.int64)
        h = _surfel_hit(m[g], Dk[g], mean2d[g], opacity[g], px[:k], py[:k])
        contrib = (r < nc[:k]) & (h.alpha > 0.0)
        one_m_a = 1.0 - h.alpha
        Tb = torch.where(contrib, T[:k] / one_m_a, T[:k])  # T before this entry
        w = torch.where(contrib, h.alpha * Tb, 0.0)
        dep = h.depth
        payload = ((colors[g][:, None, :] * dC[:k]).sum(-1) + dep * dDs[:k]
                   + dep * dep * dM2[:k] + (normals[g][:, None, :] * dN[:k]).sum(-1) + dA[:k])
        dL_dalpha = torch.where(contrib, Tb * payload - Sq[:k] / one_m_a, 0.0)
        cross = contrib & (Tb > 0.5) & (Tb * one_m_a < 0.5)
        drho = -0.5 * h.G * (opacity[g][:, None] * dL_dalpha)  # no 0.99-clamp gate
        ddep = w * dDs[:k] + 2.0 * dep * w * dM2[:k] + torch.where(cross, dMed[:k], 0.0)
        ddep3 = torch.where(h.use3d, ddep, 0.0)  # depth flows through (u, v) on the 3D branch
        du = torch.where(h.use3d, 2.0 * h.u * drho, 0.0) + Dk[g, 0][:, None] * ddep3
        dv = torch.where(h.use3d, 2.0 * h.v * drho, 0.0) + Dk[g, 1][:, None] * ddep3
        ds0 = du / h.sz
        ds1 = dv / h.sz
        ds2 = torch.where(h.guarded, 0.0, -(h.u * du + h.v * dv) / h.sz)
        hu, hv = h.hu, h.hv
        # s = hu x hv: dhu = hv x ds, dhv = ds x hu
        dhu = (hv[1] * ds2 - hv[2] * ds1, hv[2] * ds0 - hv[0] * ds2, hv[0] * ds1 - hv[1] * ds0)
        dhv = (ds1 * hu[2] - ds2 * hu[1], ds2 * hu[0] - ds0 * hu[2], ds0 * hu[1] - ds1 * hu[0])
        drho2 = torch.where(h.use3d, 0.0, drho)  # the centre moves rho2d only
        per_px = torch.stack(
            [-d for d in dhu] + [-d for d in dhv] + [px[:k] * a + py[:k] * b for a, b in zip(dhu, dhv)]
            + [h.u * ddep3, h.v * ddep3, ddep, h.G * dL_dalpha]
            + [w * dC[:k, :, c] for c in range(3)] + [w * dN[:k, :, c] for c in range(3)]
            + [drho2 * h.dx, drho2 * h.dy], dim=-1)
        acc.index_add_(0, g, torch.where(contrib[..., None], per_px, 0.0).sum(dim=1))
        Sq[:k] += w * payload
        T[:k] = Tb
    return _split_grads(acc)


def _split_grads(acc) -> SurfelGrads:
    n = acc.shape[0]
    return SurfelGrads(M=acc[:, 0:9].reshape(n, 3, 3), Dk=acc[:, 9:12], mean2d=acc[:, 19:21],
                       opacity=acc[:, 12], colors=acc[:, 13:16], normal=acc[:, 16:19])


def render_surfel_tiles_backward(
        ranges, point_list, M, Dk, mean2d, opacity, colors, normals, final_T, n_contrib,
        dL_dcolor, dL_ddepth_sum, dL_dm2, dL_dnormal, dL_dfinal_T, dL_dmedian,
        grid_x: int, grid_y: int, W: int, H: int) -> SurfelGrads:
    """K6: per-Gaussian gradients of the surfel compositor; the kernel for
    CUDA tensors."""
    if not opacity.is_cuda:
        return render_surfel_tiles_backward_plain(
            ranges, point_list, M, Dk, mean2d, opacity, colors, normals, final_T, n_contrib,
            dL_dcolor, dL_ddepth_sum, dL_dm2, dL_dnormal, dL_dfinal_T, dL_dmedian,
            grid_x, grid_y, W, H)
    ins = _entry_inputs("render_surfel_tiles_backward", ranges, point_list, M, Dk, mean2d,
                        opacity, colors, normals, grid_x * grid_y)
    per_pixel = (final_T.float().contiguous(), n_contrib.int().contiguous(),
                 dL_dcolor.float().contiguous(), dL_ddepth_sum.float().contiguous(),
                 dL_dm2.float().contiguous(), dL_dnormal.float().contiguous(),
                 dL_dfinal_T.float().contiguous(), dL_dmedian.float().contiguous())
    kernels.require_cuda("render_surfel_tiles_backward", *per_pixel)
    for field, t, size in zip(
            ("final_T", "n_contrib", "dL_dcolor", "dL_ddepth_sum", "dL_dm2", "dL_dnormal",
             "dL_dfinal_T", "dL_dmedian"), per_pixel,
            (H * W, H * W, 3 * H * W, H * W, H * W, 3 * H * W, H * W, H * W)):
        if t.numel() != size:
            raise ValueError(f"render_surfel_tiles_backward: {field} must hold {size} values, "
                             f"got shape {tuple(t.shape)}")
    acc = torch.zeros((ins[5].numel(), NUM_GRADS), dtype=torch.float32, device=opacity.device)
    kernels.check(kernels.load().gs_render_surfel_tiles_backward(
        grid_x, grid_y, W, H, *(t.data_ptr() for t in ins + per_pixel), acc.data_ptr(),
        kernels.stream()), "gs_render_surfel_tiles_backward")
    render_surfel_tiles_backward.launches += 1
    return _split_grads(acc)


render_surfel_tiles_backward.launches = 0


class _CompositeSurfel(torch.autograd.Function):
    """Forward K5 / backward K6 (their plain versions for CPU tensors, or
    everywhere with ``plain``). Differentiable in M, Dk, mean2d, opacity,
    colours and normals; the median weight and id and n_contrib are not."""

    @staticmethod
    def forward(ctx, M, Dk, mean2d, opacity, colors, normals, ranges, point_list, grid, plain):
        render = render_surfel_tiles_plain if plain else render_surfel_tiles
        out = render(ranges, point_list, M, Dk, mean2d, opacity, colors, normals, *grid)
        ctx.mark_non_differentiable(out.median_weight, out.median_id, out.n_contrib)
        ctx.save_for_backward(M, Dk, mean2d, opacity, colors, normals, ranges, point_list,
                              out.final_T, out.n_contrib)
        ctx.grid, ctx.plain = grid, plain
        return tuple(out)

    @staticmethod
    def backward(ctx, d_color, d_depth_sum, d_normal, d_median_depth, _d_median_weight,
                 _d_median_id, d_final_T, d_m2, _d_n_contrib):
        (M, Dk, mean2d, opacity, colors, normals, ranges, point_list, final_T,
         n_contrib) = ctx.saved_tensors
        _, _, W, H = ctx.grid
        zero = lambda d, shape: torch.zeros(shape, device=final_T.device) if d is None else d  # noqa: E731
        backward = render_surfel_tiles_backward_plain if ctx.plain else render_surfel_tiles_backward
        with annotate("gs.composite_bwd", final_T):
            g = backward(ranges, point_list, M, Dk, mean2d, opacity, colors, normals, final_T,
                         n_contrib, zero(d_color, (3, H, W)), zero(d_depth_sum, (H, W)),
                         zero(d_m2, (H, W)), zero(d_normal, (3, H, W)),
                         zero(d_final_T, (H, W)), zero(d_median_depth, (H, W)), *ctx.grid)
        return g.M, g.Dk, g.mean2d, g.opacity, g.colors, g.normal, None, None, None, None


def composite_surfel(M, Dk, mean2d, opacity, colors, normals, ranges, point_list, grid_x: int,
                     grid_y: int, W: int, H: int, plain: bool = False) -> SurfelCompositeOut:
    """Differentiable compositing of the binned surfel entries (see
    :class:`_CompositeSurfel`)."""
    return SurfelCompositeOut(*_CompositeSurfel.apply(
        M, Dk, mean2d, opacity, colors, normals, ranges, point_list, (grid_x, grid_y, W, H),
        plain))
