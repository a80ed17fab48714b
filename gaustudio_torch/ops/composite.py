"""Tile compositing: K3 :func:`render_tiles` and its plain PyTorch version.

K3 (csrc/composite.cu) replaces gaustudio_tpu/ops/rasterize_pallas.py
_composite_kernel. The plain version is the forward of the golden
gaustudio_tpu/ops/rasterize_ref.py, written as a loop over the in-tile rank
of the sorted entries, vectorised over every tile and pixel. The rules:

* alpha = min(0.99, op * exp(power)); an entry is skipped where power > 0 or
  alpha < 1/255;
* an entry is applied iff T * (1 - alpha) >= 1e-4; the first that is not
  ends the pixel's walk; ``final_T`` is the last applied T;
* the median depth / weight / id is taken at the applied entry where T
  crosses 0.5 (T before > 0.5, T after < 0.5; default depth 15);
* ``n_contrib`` is 1 + the in-tile position of the last applied entry.

The background is not composited (the reference composites it in the loss).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gaustudio_torch.ops.gaussian import TILE_PIXELS, TILE_X, TILE_Y
from gaustudio_torch.utils import kernels

_ALPHA_MAX = 0.99
_ALPHA_MIN = 1.0 / 255.0
_TERM_EPS = 1e-4
_MEDIAN_DEFAULT = 15.0


class CompositeOut(NamedTuple):
    color: torch.Tensor  # [3, H, W]
    depth: torch.Tensor  # [1, H, W] expected depth
    median_depth: torch.Tensor  # [1, H, W]
    median_weight: torch.Tensor  # [1, H, W]
    median_id: torch.Tensor  # [1, H, W] int32
    final_T: torch.Tensor  # [H, W]
    n_contrib: torch.Tensor  # [H, W] int32


def tiles_to_image(tiled: torch.Tensor, grid_x: int, grid_y: int, H: int, W: int):
    """[T, 256, ...] tile-major pixels -> [H, W, ...] image crop."""
    trailing = tuple(tiled.shape[2:])
    img = tiled.reshape((grid_y, grid_x, TILE_Y, TILE_X) + trailing)
    img = img.transpose(1, 2).reshape((grid_y * TILE_Y, grid_x * TILE_X) + trailing)
    return img[:H, :W]


def render_tiles_plain(ranges, point_list, means2d, conic, opacity, colors, depths,
                       grid_x: int, grid_y: int, W: int, H: int) -> CompositeOut:
    """Plain version of K3, same inputs and outputs."""
    device = means2d.device
    num_tiles = grid_x * grid_y
    starts = ranges[:, 0].to(torch.int64)
    counts = (ranges[:, 1] - ranges[:, 0]).to(torch.int64)
    # tiles in descending run length: at rank r the live tiles are a prefix
    order = torch.argsort(counts, descending=True, stable=True)
    starts = starts[order]
    counts_host = counts[order].cpu().numpy()
    q = torch.arange(TILE_PIXELS, device=device)
    px = ((order % grid_x) * TILE_X)[:, None] + q % TILE_X
    py = ((order // grid_x) * TILE_Y)[:, None] + q // TILE_X
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

    # live[r] = number of tiles whose run is longer than r
    max_count = int(counts_host[0]) if num_tiles else 0
    live = np.searchsorted(-counts_host, -np.arange(max_count), side="left")
    for r in range(max_count):
        k = int(live[r])
        g = point_list[starts[:k] + r].to(torch.int64)
        dx = means2d[g, 0][:, None] - px[:k]
        dy = means2d[g, 1][:, None] - py[:k]
        a, b, c = conic[g, 0][:, None], conic[g, 1][:, None], conic[g, 2][:, None]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp_max(opacity[g][:, None] * torch.exp(power), _ALPHA_MAX)
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
    if ins[0].shape != (grid_x * grid_y, 2):
        raise ValueError(f"render_tiles: ranges {tuple(ins[0].shape)} != ({grid_x * grid_y}, 2)")
    n = depths.numel()
    for name, t, width in zip(("means2d", "conic", "opacity", "colors"), ins[2:6], (2, 3, 1, 3)):
        if t.numel() != n * width:
            raise ValueError(f"render_tiles: {name} must hold {n} x {width} values, "
                             f"got shape {tuple(t.shape)}")
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
