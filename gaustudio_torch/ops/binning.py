"""Tile binning: Gaussians -> (tile, depth)-sorted entries + per-tile ranges.

One module for the work of gaustudio_tpu/ops/binning.py and
binning_fast.py. It holds two CUDA kernels (csrc/binning.cu), each beside
its plain PyTorch version:

* K1 :func:`duplicate_with_keys` (replaces binning_fast.py:230
  ``_fused_expand_kernel``): one entry per (Gaussian, tile) of the
  Gaussian's tight rect that survives the exact max-alpha tile cull, keyed
  ``tile << 32 | float_bits(depth)``, Gaussian-major and row-major within a
  rect. With ``cull=False`` (2DGS surfels, as ``fused_expand(cull=False)``
  and the golden ``binning.bin_gaussians``) every tile of the rect is kept.
  On the card K1 is bound by the cull's arithmetic per candidate and by the
  12 bytes written per entry, and rect sizes are skewed (a few tiles at the
  median, hundreds at the tail). So a warp walks the flattened candidates
  of its 32 Gaussians 32 at a time, as the TPU kernel walks its slots, and
  compacts the kept ones with a ballot: ceil(sum / 32) iterations a warp
  instead of its largest rect, and stores of neighbouring lanes on
  neighbouring addresses. The count pass gives each warp's output offset
  and the entry count (its last block to finish scans the block totals),
  read back once to size the outputs (the single host wait of a forward
  pass, as in the CUDA reference); the write pass repeats the walk.
* K2 :func:`identify_tile_ranges` (replaces binning_fast._ranges_kernel):
  the [start, end) run of every tile in the sorted entries.

The sort between them is ``torch.sort(stable=True)``, as it was XLA's sort
in JAX: ties keep Gaussian order, like the golden binning.bin_gaussians.
There is no static capacity. A wrapper runs its plain version only for CPU
tensors; for CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaustudio_torch.ops.gaussian import TILE_X, Preprocessed
from gaustudio_torch.utils import kernels
from gaustudio_torch.utils.observability import annotate, count


class Binned(NamedTuple):
    point_list: torch.Tensor  # [L] int32 Gaussian index of each sorted entry
    ranges: torch.Tensor  # [T, 2] int32 [start, end) of each tile (0, 0 if empty)
    num_rendered: int  # L, entries after the tile cull (if any)


def tile_max_alpha_keep(mx, my, a, b, c, op, tx, ty):
    """True iff the entry's max alpha over its 16x16 tile can reach 1/255.

    Port of gaustudio_tpu/ops/binning_fast.py _tile_max_alpha_keep: the
    minimum of d^T Q d over the tile's pixel box is 0 (mean inside) or sits
    on one of the four edges at the clamped vertex of a 1-D quadratic.
    """
    x0 = tx.to(torch.float32) * TILE_X
    x1 = x0 + TILE_X - 1
    y0 = ty.to(torch.float32) * TILE_X
    y1 = y0 + TILE_X - 1
    inside = (mx >= x0) & (mx <= x1) & (my >= y0) & (my <= y1)

    dx0 = mx - x1
    dx1 = mx - x0
    dy0 = my - y1
    dy1 = my - y0
    safe_a = torch.where(torch.abs(a) > 1e-12, a, 1e-12)
    safe_c = torch.where(torch.abs(c) > 1e-12, c, 1e-12)

    def q(dx, dy):
        return a * dx * dx + 2.0 * b * dx * dy + c * dy * dy

    def edge_y(dy):  # minimise over dx in [dx0, dx1] at fixed dy
        return q(torch.minimum(torch.maximum(-b * dy / safe_a, dx0), dx1), dy)

    def edge_x(dx):  # minimise over dy in [dy0, dy1] at fixed dx
        return q(dx, torch.minimum(torch.maximum(-b * dx / safe_c, dy0), dy1))

    m = torch.minimum(torch.minimum(edge_y(dy0), edge_y(dy1)),
                      torch.minimum(edge_x(dx0), edge_x(dx1)))
    min_q = torch.where(inside, 0.0, m)
    # keep iff op * exp(-0.5 min_q) >= 1/255
    thresh = 2.0 * torch.log(torch.clamp_min(op, 1e-12) * 255.0)
    return (min_q <= thresh) & (op * 255.0 >= 1.0)


def _depth_bits(depths):
    return depths.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def duplicate_with_keys_plain(pre: Preprocessed, grid_x: int, cull: bool = True):
    """Plain version of K1 -> (keys [L] int64, gids [L] int32), Gaussian-major,
    tiles in row-major rect order."""
    device = pre.depths.device
    tiles = pre.tiles_touched.to(torch.int64)
    n = tiles.shape[0]
    g = torch.repeat_interleave(torch.arange(n, device=device), tiles)
    starts = torch.cumsum(tiles, 0) - tiles
    j = torch.arange(g.shape[0], device=device) - starts[g]
    rmin = pre.rect_min[g].to(torch.int64)
    rect_w = torch.clamp_min(pre.rect_max[g, 0].to(torch.int64) - rmin[:, 0], 1)
    tx = rmin[:, 0] + j % rect_w
    ty = rmin[:, 1] + j // rect_w
    keys = ((ty * grid_x + tx) << 32) | _depth_bits(pre.depths)[g]
    if not cull:
        return keys, g.to(torch.int32)
    keep = tile_max_alpha_keep(
        pre.means2d[g, 0], pre.means2d[g, 1], pre.conic[g, 0], pre.conic[g, 1],
        pre.conic[g, 2], pre.opacities[g], tx, ty)
    return keys[keep], g[keep].to(torch.int32)


def _kernel_input(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` itself where it already is a contiguous ``dtype`` tensor."""
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def duplicate_with_keys(pre: Preprocessed, grid_x: int, cull: bool = True):
    """K1: (keys [L] int64, gids [L] int32), the kernel for CUDA tensors."""
    if not pre.means2d.is_cuda:
        return duplicate_with_keys_plain(pre, grid_x, cull)
    f32, i32 = torch.float32, torch.int32
    rect_min, rect_max = _kernel_input(pre.rect_min, i32), _kernel_input(pre.rect_max, i32)
    tiles = _kernel_input(pre.tiles_touched, i32)
    # the cull alone reads the splat
    splat = (_kernel_input(pre.means2d, f32), _kernel_input(pre.conic, f32),
             _kernel_input(pre.opacities, f32)) if cull else ()
    kernels.require_cuda("duplicate_with_keys", rect_min, rect_max, tiles, *splat)
    # depth is read by stride: preprocess hands over a column of a wider tensor
    depths = pre.depths if pre.depths.dtype == f32 and pre.depths.dim() == 1 else \
        pre.depths.reshape(-1).to(f32)
    n, device = depths.shape[0], rect_min.device
    if depths.device != device:
        raise ValueError(f"duplicate_with_keys: depths on {depths.device}, rects on {device}")
    for t, width in zip((rect_min, rect_max, tiles) + splat, (2, 2, 1, 2, 3, 1)):
        if t.numel() != n * width:
            raise ValueError(f"duplicate_with_keys: expected {n} x {width} values, "
                             f"got shape {tuple(t.shape)}")
    if n == 0:
        return (torch.empty(0, dtype=torch.int64, device=device),
                torch.empty(0, dtype=torch.int32, device=device))
    # the inputs stay bound (and so alive) until both launches are queued
    ptrs = ([t.data_ptr() for t in splat] or [0, 0, 0]) + [
        t.data_ptr() for t in (rect_min, rect_max, tiles)]
    lib = kernels.load()
    num_warps, num_blocks = (n + 31) // 32, (n + 255) // 256
    # the warps' counts, the blocks' offsets, the entry count and, with the
    # cull, 32 keep masks of 4 bytes a warp (csrc/binning.cu count_entries_kernel)
    scratch = torch.empty(num_warps + num_blocks + 1 + (16 * num_warps if cull else 0),
                          dtype=torch.int64, device=device)
    kernels.check(lib.gs_count_entries(n, *ptrs, int(cull), scratch.data_ptr(),
                                       kernels.stream()), "gs_count_entries")
    duplicate_with_keys.launches += 1
    with annotate("gs.bin.readback"):
        num_rendered = int(scratch[num_warps + num_blocks])
    if num_rendered >= 2**31:  # the range and render kernels index entries with int
        raise ValueError(f"duplicate_with_keys: {num_rendered} entries exceed int32")
    keys = torch.empty(num_rendered, dtype=torch.int64, device=device)
    gids = torch.empty(num_rendered, dtype=torch.int32, device=device)
    if num_rendered:
        kernels.check(lib.gs_write_entries(n, grid_x, *ptrs, depths.data_ptr(), depths.stride(0),
                                           int(cull), scratch.data_ptr(), keys.data_ptr(),
                                           gids.data_ptr(), kernels.stream()),
                      "gs_write_entries")
    return keys, gids


duplicate_with_keys.launches = 0


def identify_tile_ranges_plain(sorted_keys: torch.Tensor, num_tiles: int) -> torch.Tensor:
    """Plain version of K2: searchsorted of each tile id over the sorted
    tiles -> [T, 2] int32, (0, 0) for an empty tile."""
    tiles = (sorted_keys >> 32).to(torch.int32)
    pos = torch.searchsorted(
        tiles, torch.arange(num_tiles + 1, dtype=torch.int32, device=tiles.device)
    ).to(torch.int32)
    ranges = torch.stack([pos[:-1], pos[1:]], dim=1)
    return torch.where((ranges[:, 1:] > ranges[:, :1]), ranges, 0)


def identify_tile_ranges(sorted_keys: torch.Tensor, num_tiles: int) -> torch.Tensor:
    """K2: [T, 2] int32 tile runs, the kernel for CUDA tensors."""
    if not sorted_keys.is_cuda:
        return identify_tile_ranges_plain(sorted_keys, num_tiles)
    keys = sorted_keys.contiguous()
    kernels.require_cuda("identify_tile_ranges", keys)
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError(f"identify_tile_ranges: expected 1-D int64 keys, "
                         f"got {keys.dtype} {tuple(keys.shape)}")
    if not keys.shape[0]:
        return torch.zeros((num_tiles, 2), dtype=torch.int32, device=keys.device)
    ranges = torch.empty((num_tiles, 2), dtype=torch.int32, device=keys.device)  # K2 writes all
    kernels.check(kernels.load().gs_identify_tile_ranges(
        keys.shape[0], num_tiles, keys.data_ptr(), ranges.data_ptr(), kernels.stream()),
        "gs_identify_tile_ranges")
    identify_tile_ranges.launches += 1
    return ranges


identify_tile_ranges.launches = 0


def bin_gaussians(pre: Preprocessed, grid_x: int, grid_y: int, plain: bool = False,
                  cull: bool = True) -> Binned:
    """Duplicate, sort and range the (Gaussian, tile) entries.

    ``plain=True`` runs the plain versions whatever the device; ``cull=False``
    keeps every tile of each rect (surfels).
    """
    dup = duplicate_with_keys_plain if plain else duplicate_with_keys
    ranges_fn = identify_tile_ranges_plain if plain else identify_tile_ranges
    with annotate("gs.bin", pre.means2d):
        keys, gids = dup(pre, grid_x, cull)
        sorted_keys, order = torch.sort(keys, stable=True)
        binned = Binned(
            point_list=gids[order],
            ranges=ranges_fn(sorted_keys, grid_x * grid_y),
            num_rendered=int(keys.shape[0]),
        )
    count("gs.rect_tiles", pre.tiles_touched)
    count("gs.entries", binned.num_rendered)
    return binned
