"""Tile compositing: K3 :func:`render_tiles`, K4 :func:`render_tiles_backward`,
their plain PyTorch versions, and :func:`composite`, the autograd Function
that joins the two.

K3 (csrc/composite.cu) replaces gaustudio_tpu/ops/rasterize_pallas.py
_composite_kernel. K4 (csrc/composite_bwd.cu) replaces
gaustudio_tpu/ops/rasterize_pallas_bwd.py _backward_kernel and
_segreduce_kernel, and makes binning_fast._realign_kernel unneeded: both
kernels read each tile's run in place through the ranges of binning.

The plain versions are the golden gaustudio_tpu/ops/rasterize_ref.py
(composite and _composite_bwd), written as loops over the in-tile rank of
the sorted entries, vectorised over every tile and pixel. The rules:

* alpha = min(0.99, op * exp(power)); an entry is skipped where power > 0 or
  alpha < 1/255;
* an entry is applied iff T * (1 - alpha) >= 1e-4; the first that is not
  ends the pixel's walk; ``final_T`` is the last applied T;
* the median depth / weight / id is taken at the applied entry where T
  crosses 0.5 (T before > 0.5, T after < 0.5; default depth 15);
* ``n_contrib`` is 1 + the in-tile position of the last applied entry.

The background is not composited in the forward (the reference composites
it in the loss); the backward keeps the reference's background term of
dL/dalpha, fed from ``bg``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gaustudio_torch.ops.gaussian import TILE_PIXELS, TILE_X, TILE_Y
from gaustudio_torch.utils import kernels
from gaustudio_torch.utils.observability import annotate

_ALPHA_MAX = 0.99
_ALPHA_MIN = 1.0 / 255.0
_TERM_EPS = 1e-4
_MEDIAN_DEFAULT = 15.0
NUM_GRADS = 10  # per Gaussian: d_mean 2, d_conic 3, d_opacity, d_colour 3, d_depth


class CompositeOut(NamedTuple):
    color: torch.Tensor  # [3, H, W]
    depth: torch.Tensor  # [1, H, W] expected depth
    median_depth: torch.Tensor  # [1, H, W]
    median_weight: torch.Tensor  # [1, H, W]
    median_id: torch.Tensor  # [1, H, W] int32
    final_T: torch.Tensor  # [H, W]
    n_contrib: torch.Tensor  # [H, W] int32


class CompositeGrads(NamedTuple):
    means2d: torch.Tensor  # [N, 2]
    conic: torch.Tensor  # [N, 3]
    opacity: torch.Tensor  # [N]
    colors: torch.Tensor  # [N, 3]
    depths: torch.Tensor  # [N]


def tiles_to_image(tiled: torch.Tensor, grid_x: int, grid_y: int, H: int, W: int):
    """[T, 256, ...] tile-major pixels -> [H, W, ...] image crop."""
    trailing = tuple(tiled.shape[2:])
    img = tiled.reshape((grid_y, grid_x, TILE_Y, TILE_X) + trailing)
    img = img.transpose(1, 2).reshape((grid_y * TILE_Y, grid_x * TILE_X) + trailing)
    return img[:H, :W]


def image_to_tiles(img: torch.Tensor, grid_x: int, grid_y: int):
    """[H, W, ...] image -> [T, 256, ...] tile-major pixels, zero past the edge."""
    H, W = img.shape[:2]
    trailing = tuple(img.shape[2:])
    full = img.new_zeros((grid_y * TILE_Y, grid_x * TILE_X) + trailing)
    full[:H, :W] = img
    full = full.reshape((grid_y, TILE_Y, grid_x, TILE_X) + trailing).transpose(1, 2)
    return full.reshape((grid_y * grid_x, TILE_PIXELS) + trailing)


def _tile_pixels(tiles: torch.Tensor, grid_x: int):
    """Pixel coordinates (px, py) [len(tiles), 256] int64 of the given tiles."""
    q = torch.arange(TILE_PIXELS, device=tiles.device)
    px = ((tiles % grid_x) * TILE_X)[:, None] + q % TILE_X
    py = ((tiles // grid_x) * TILE_Y)[:, None] + q // TILE_X
    return px, py


def _entry_alpha(means2d, conic, opacity, g, px, py):
    """(dx, dy, power, G, alpha) of entries ``g`` [k] against the pixels
    ``px``, ``py`` [k, 256] of their tiles; every op rounds once, as the
    kernels' unfused ``gs_power`` does."""
    dx = means2d[g, 0][:, None] - px
    dy = means2d[g, 1][:, None] - py
    a, b, c = conic[g, 0][:, None], conic[g, 1][:, None], conic[g, 2][:, None]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    G = torch.exp(power)
    alpha = torch.clamp_max(opacity[g][:, None] * G, _ALPHA_MAX)
    return dx, dy, power, G, alpha


def _live_tiles(run: torch.Tensor):
    """Tiles in descending ``run`` length, and live[r] = the number of them
    whose run is longer than r: at rank r the live tiles are a prefix."""
    order = torch.argsort(run, descending=True, stable=True)
    run_host = run[order].cpu().numpy()
    longest = int(run_host[0]) if run_host.size else 0
    live = np.searchsorted(-run_host, -np.arange(longest), side="left")
    return order, live


def render_tiles_plain(ranges, point_list, means2d, conic, opacity, colors, depths,
                       grid_x: int, grid_y: int, W: int, H: int) -> CompositeOut:
    """Plain version of K3, same inputs and outputs."""
    device = means2d.device
    num_tiles = grid_x * grid_y
    order, live = _live_tiles((ranges[:, 1] - ranges[:, 0]).to(torch.int64))
    starts = ranges[order, 0].to(torch.int64)
    px, py = _tile_pixels(order, grid_x)
    done = (px >= W) | (py >= H)  # outside pixels never composite
    px, py = px.to(torch.float32), py.to(torch.float32)

    shape = (num_tiles, TILE_PIXELS)
    T = torch.ones(shape, dtype=torch.float32, device=device)
    C = torch.zeros(shape + (3,), dtype=torch.float32, device=device)
    D = torch.zeros(shape, dtype=torch.float32, device=device)
    med_d = torch.full(shape, _MEDIAN_DEFAULT, dtype=torch.float32, device=device)
    med_w = torch.zeros(shape, dtype=torch.float32, device=device)
    med_i = torch.zeros(shape, dtype=torch.int32, device=device)
    n_con = torch.zeros(shape, dtype=torch.int32, device=device)

    for r in range(len(live)):
        k = int(live[r])
        g = point_list[starts[:k] + r].to(torch.int64)
        _, _, power, _, alpha = _entry_alpha(means2d, conic, opacity, g, px[:k], py[:k])
        Tk = T[:k]
        test_T = Tk * (1.0 - alpha)
        live_px = ~done[:k] & (power <= 0.0) & (alpha >= _ALPHA_MIN)
        stop = live_px & (test_T < _TERM_EPS)
        apply = live_px & ~stop
        done[:k] |= stop
        w = torch.where(apply, alpha * Tk, 0.0)
        C[:k] += w[..., None] * colors[g][:, None, :]
        dep = depths[g][:, None]
        D[:k] += w * dep
        cross = apply & (Tk > 0.5) & (test_T < 0.5)
        med_d[:k] = torch.where(cross, dep, med_d[:k])
        med_w[:k] = torch.where(cross, w, med_w[:k])
        med_i[:k] = torch.where(cross, g.to(torch.int32)[:, None], med_i[:k])
        n_con[:k] = torch.where(apply, r + 1, n_con[:k])
        T[:k] = torch.where(apply, test_T, Tk)

    inv = torch.empty_like(order)
    inv[order] = torch.arange(num_tiles, device=device)
    img = lambda x: tiles_to_image(x[inv], grid_x, grid_y, H, W)
    return CompositeOut(
        color=img(C).permute(2, 0, 1).contiguous(),
        depth=img(D)[None],
        median_depth=img(med_d)[None],
        median_weight=img(med_w)[None],
        median_id=img(med_i)[None],
        final_T=img(T),
        n_contrib=img(n_con),
    )


def render_tiles(ranges, point_list, means2d, conic, opacity, colors, depths,
                 grid_x: int, grid_y: int, W: int, H: int) -> CompositeOut:
    """K3: composite every tile; the kernel for CUDA tensors."""
    if not means2d.is_cuda:
        return render_tiles_plain(ranges, point_list, means2d, conic, opacity, colors,
                                  depths, grid_x, grid_y, W, H)
    ins = (ranges.int().contiguous(), point_list.int().contiguous(),
           means2d.float().contiguous(), conic.float().contiguous(),
           opacity.float().contiguous(), colors.float().contiguous(),
           depths.float().contiguous())
    kernels.require_cuda("render_tiles", *ins)
    _check_entries("render_tiles", ins, grid_x * grid_y)
    f32 = dict(dtype=torch.float32, device=means2d.device)
    i32 = dict(dtype=torch.int32, device=means2d.device)
    out = CompositeOut(
        color=torch.empty((3, H, W), **f32),
        depth=torch.empty((1, H, W), **f32),
        median_depth=torch.empty((1, H, W), **f32),
        median_weight=torch.empty((1, H, W), **f32),
        median_id=torch.empty((1, H, W), **i32),
        final_T=torch.empty((H, W), **f32),
        n_contrib=torch.empty((H, W), **i32),
    )
    kernels.check(kernels.load().gs_render_tiles(
        grid_x, grid_y, W, H, *(t.data_ptr() for t in ins),
        *(t.data_ptr() for t in out), kernels.stream()), "gs_render_tiles")
    render_tiles.launches += 1
    return out


render_tiles.launches = 0


def _check_entries(name, ins, num_tiles):
    """Shapes of (ranges, point_list, means2d, conic, opacity, colors, depths)."""
    if ins[0].shape != (num_tiles, 2):
        raise ValueError(f"{name}: ranges {tuple(ins[0].shape)} != ({num_tiles}, 2)")
    n = ins[6].numel()
    for field, t, width in zip(("means2d", "conic", "opacity", "colors"), ins[2:6], (2, 3, 1, 3)):
        if t.numel() != n * width:
            raise ValueError(f"{name}: {field} must hold {n} x {width} values, "
                             f"got shape {tuple(t.shape)}")


def render_tiles_backward_plain(ranges, point_list, means2d, conic, opacity, colors, depths,
                                bg, final_T, n_contrib, dL_dcolor, dL_ddepth, dL_dfinal_T,
                                dL_dmedian, grid_x: int, grid_y: int, W: int,
                                H: int) -> CompositeGrads:
    """Plain version of K4: the reverse walk of rasterize_ref._composite_bwd.

    ``final_T`` and ``n_contrib`` [H, W] are the forward's; the cotangents are
    dL/dcolor [3, H, W] and dL/ddepth, dL/dfinal_T, dL/dmedian_depth, each
    [H, W] or [1, H, W]. Each pixel walks its positions below ``n_contrib``
    backwards, rebuilds T by division and keeps the suffix sums of the
    entries behind; per-Gaussian sums go through ``index_add_``.
    """
    device = means2d.device
    n = depths.shape[0]
    tiles = lambda x: image_to_tiles(x, grid_x, grid_y)
    nc = tiles(n_contrib.reshape(H, W)).to(torch.int64)
    order, live = _live_tiles(nc.max(dim=1).values)
    starts = ranges[order, 0].to(torch.int64)
    px, py = (p.to(torch.float32) for p in _tile_pixels(order, grid_x))
    nc = nc[order]
    T_final = tiles(final_T.reshape(H, W))[order]
    dC = tiles(dL_dcolor.reshape(3, H, W).permute(1, 2, 0))[order]  # [T, 256, 3]
    dD = tiles(dL_ddepth.reshape(H, W))[order]
    dO = -tiles(dL_dfinal_T.reshape(H, W))[order]  # d(1 - T) = -dT
    dMed = tiles(dL_dmedian.reshape(H, W))[order]
    bg_dot = dC @ bg.to(dC)

    T = T_final.clone()
    S = torch.zeros_like(dC)  # suffix sums of w * colour, w * depth and w
    SD = torch.zeros_like(T)
    SO = torch.zeros_like(T)
    acc = torch.zeros((n, NUM_GRADS), dtype=torch.float32, device=device)
    for r in range(len(live) - 1, -1, -1):
        k = int(live[r])
        g = point_list[starts[:k] + r].to(torch.int64)
        dx, dy, power, G, alpha = _entry_alpha(means2d, conic, opacity, g, px[:k], py[:k])
        contrib = (r < nc[:k]) & (power <= 0.0) & (alpha >= _ALPHA_MIN)
        one_m_a = 1.0 - alpha
        Tb = torch.where(contrib, T[:k] / one_m_a, T[:k])  # T before this entry
        w = torch.where(contrib, alpha * Tb, 0.0)
        col = colors[g][:, None, :]
        dep = depths[g][:, None]
        dCk = dC[:k]
        dL_dalpha = (
            Tb * (col * dCk).sum(-1) - (S[:k] * dCk).sum(-1) / one_m_a
            + Tb * dep * dD[:k] - SD[:k] / one_m_a * dD[:k]
            + Tb * dO[:k] - SO[:k] / one_m_a * dO[:k]
            - T_final[:k] / one_m_a * bg_dot[:k]
        )
        dL_dalpha = torch.where(contrib, dL_dalpha, 0.0)
        cross = contrib & (Tb > 0.5) & (Tb * one_m_a < 0.5)
        dpow = G * opacity[g][:, None] * dL_dalpha  # no 0.99-clamp gate
        a, b, c = conic[g, 0][:, None], conic[g, 1][:, None], conic[g, 2][:, None]
        per_px = torch.stack([
            dpow * -(a * dx + b * dy),
            dpow * -(c * dy + b * dx),
            dpow * (-0.5 * dx * dx),
            dpow * (-dx * dy),
            dpow * (-0.5 * dy * dy),
            G * dL_dalpha,  # no extra final-opacity term
            w * dCk[..., 0],
            w * dCk[..., 1],
            w * dCk[..., 2],
            w * dD[:k] + torch.where(cross, dMed[:k], 0.0),
        ], dim=-1)
        acc.index_add_(0, g, per_px.sum(dim=1))
        S[:k] += w[..., None] * col
        SD[:k] += w * dep
        SO[:k] += w
        T[:k] = Tb
    return _split_grads(acc)


def _split_grads(acc) -> CompositeGrads:
    return CompositeGrads(means2d=acc[:, 0:2], conic=acc[:, 2:5], opacity=acc[:, 5],
                          colors=acc[:, 6:9], depths=acc[:, 9])


def render_tiles_backward(ranges, point_list, means2d, conic, opacity, colors, depths, bg,
                          final_T, n_contrib, dL_dcolor, dL_ddepth, dL_dfinal_T, dL_dmedian,
                          grid_x: int, grid_y: int, W: int, H: int) -> CompositeGrads:
    """K4: per-Gaussian gradients of the compositor; the kernel for CUDA tensors."""
    if not means2d.is_cuda:
        return render_tiles_backward_plain(
            ranges, point_list, means2d, conic, opacity, colors, depths, bg, final_T,
            n_contrib, dL_dcolor, dL_ddepth, dL_dfinal_T, dL_dmedian, grid_x, grid_y, W, H)
    ins = (ranges.int().contiguous(), point_list.int().contiguous(),
           means2d.float().contiguous(), conic.float().contiguous(),
           opacity.float().contiguous(), colors.float().contiguous(),
           depths.float().contiguous())
    per_pixel = (bg.float().contiguous(), final_T.float().contiguous(),
                 n_contrib.int().contiguous(), dL_dcolor.float().contiguous(),
                 dL_ddepth.float().contiguous(), dL_dfinal_T.float().contiguous(),
                 dL_dmedian.float().contiguous())
    kernels.require_cuda("render_tiles_backward", *ins, *per_pixel)
    _check_entries("render_tiles_backward", ins, grid_x * grid_y)
    for field, t, size in zip(
            ("bg", "final_T", "n_contrib", "dL_dcolor", "dL_ddepth", "dL_dfinal_T",
             "dL_dmedian"), per_pixel, (3, H * W, H * W, 3 * H * W, H * W, H * W, H * W)):
        if t.numel() != size:
            raise ValueError(f"render_tiles_backward: {field} must hold {size} values, "
                             f"got shape {tuple(t.shape)}")
    acc = torch.zeros((depths.numel(), NUM_GRADS), dtype=torch.float32, device=means2d.device)
    kernels.check(kernels.load().gs_render_tiles_backward(
        grid_x, grid_y, W, H, *(t.data_ptr() for t in ins + per_pixel), acc.data_ptr(),
        kernels.stream()), "gs_render_tiles_backward")
    render_tiles_backward.launches += 1
    return _split_grads(acc)


render_tiles_backward.launches = 0


class _Composite(torch.autograd.Function):
    """Forward K3 / backward K4 (their plain versions for CPU tensors, or
    everywhere with ``plain``). Differentiable in means2d, conic, opacity,
    colors and depths; the median weight's cotangent is ignored, as the golden
    does, and median_id and n_contrib are not differentiable."""

    @staticmethod
    def forward(ctx, means2d, conic, opacity, colors, depths, bg, ranges, point_list,
                grid, plain):
        render = render_tiles_plain if plain else render_tiles
        out = render(ranges, point_list, means2d, conic, opacity, colors, depths, *grid)
        ctx.mark_non_differentiable(out.median_id, out.n_contrib)
        ctx.save_for_backward(means2d, conic, opacity, colors, depths, bg, ranges,
                              point_list, out.final_T, out.n_contrib)
        ctx.grid, ctx.plain = grid, plain
        return tuple(out)

    @staticmethod
    def backward(ctx, d_color, d_depth, d_median_depth, _d_median_weight, _d_median_id,
                 d_final_T, _d_n_contrib):
        (means2d, conic, opacity, colors, depths, bg, ranges, point_list, final_T,
         n_contrib) = ctx.saved_tensors
        _, _, W, H = ctx.grid
        zero = lambda d, shape: torch.zeros(shape, device=final_T.device) if d is None else d
        backward = render_tiles_backward_plain if ctx.plain else render_tiles_backward
        with annotate("gs.composite_bwd", final_T):
            grads = backward(
                ranges, point_list, means2d, conic, opacity, colors, depths, bg, final_T,
                n_contrib, zero(d_color, (3, H, W)), zero(d_depth, (H, W)),
                zero(d_final_T, (H, W)), zero(d_median_depth, (H, W)), *ctx.grid)
        return (*grads, None, None, None, None, None)


def composite(means2d, conic, opacity, colors, depths, bg, ranges, point_list,
              grid_x: int, grid_y: int, W: int, H: int, plain: bool = False) -> CompositeOut:
    """Differentiable compositing of the binned entries (see :class:`_Composite`)."""
    return CompositeOut(*_Composite.apply(means2d, conic, opacity, colors, depths, bg,
                                          ranges, point_list, (grid_x, grid_y, W, H), plain))
