"""The work each view of a traced window needs, counted by the benchmark's
own plain rasterizer (``gsbench/reference/raster.py``) on the raw
attributes and cameras that the window rendered: Gaussians in the frustum,
rect tiles, entries, tiles, pixels, and the (entry, pixel) pairs a
compositor must evaluate forward and backward. Nothing of the program is
called, so a change to how the program projects, bins, culls or fuses
leaves the count as it is.

The entries are the published rasterizer's: one per (Gaussian, tile of its
rect), with no tile cull. ``pairs_walked`` is a frozen copy of
``chip_smoke.py``'s: forward, a pixel whose final T >= 0.01 cannot have
stopped (the stop needs T (1 - alpha) < 1e-4 with alpha <= 0.99), so it
evaluates its tile's whole run, any other pixel its first n_contrib + 1
entries; backward, each pixel's positions below n_contrib (the rank + 1 of
the last entry it applied).
"""

from __future__ import annotations

import torch

from gsbench.reference import raster

TILE = 16


def _to_tiles(img, gx, gy):
    """[H, W] -> [T, 256], zero past the image's edge."""
    H, W = img.shape
    full = img.new_zeros((gy * TILE, gx * TILE))
    full[:H, :W] = img
    return full.reshape(gy, TILE, gx, TILE).transpose(1, 2).reshape(gy * gx, TILE * TILE)


def pairs_walked(ranges, final_T, n_contrib, W: int, H: int) -> tuple:
    gx, gy = (W + TILE - 1) // TILE, (H + TILE - 1) // TILE
    count = (ranges[:, 1] - ranges[:, 0]).to(torch.int64)
    per_px = _to_tiles(torch.ones((H, W), dtype=torch.int64, device=ranges.device), gx, gy)
    run = count[:, None] * per_px
    nc = _to_tiles(n_contrib.to(torch.int64), gx, gy)
    open_px = _to_tiles(final_T, gx, gy) >= 0.01
    fwd = torch.where(open_px, run, torch.minimum(nc + 1, run))
    return int(fwd.sum()), int(nc.sum())


@torch.no_grad()
def view_work(model: str, params: dict, cam: dict, scale: int, device) -> dict:
    """The counts of one view: the raw attributes ``params`` (xyz, f_dc,
    f_rest, opacity, scale, rot) seen by the cameras.json entry ``cam`` at
    1 / ``scale`` of its size."""
    v = raster.view(cam, device, scale=scale)
    sp = (raster.project_2dgs if model == "2dgs" else raster.project_3dgs)(params, v)
    e = raster.bin_entries(sp, v.W, v.H)
    out = raster.render(model, sp, e, v.W, v.H, contrib=True)
    fwd, bwd = pairs_walked(e.ranges, out["T"], out["n_contrib"], v.W, v.H)
    wh = (sp.rect_hi - sp.rect_lo).clamp_min(0)
    rect = wh[:, 0] * wh[:, 1]
    return {"gaussians": int(params["xyz"].shape[0]), "in_frustum": int((rect > 0).sum()),
            "rect_tiles": int(rect.sum()), "entries": int(e.point_list.shape[0]),
            "tiles": e.grid_x * e.grid_y, "pixels": v.W * v.H, "fwd_pairs": fwd,
            "bwd_pairs": bwd, "params": int(sum(p.numel() for p in params.values()))}


def work(ctx: dict) -> list:
    """The work of every view the traced window rendered, in order (one
    entry a forward compositor launch), from ``ctx``'s ``model``, ``params``
    (a callable that gives the attributes on the device) and ``views``
    ((cameras.json entry, scale) pairs). Counted once and kept in ``ctx``;
    None where the window rendered no view."""
    if "_work" not in ctx:
        views = ctx.get("views")
        if not views:
            ctx["_work"] = None
        else:
            params = ctx["params"]()
            device = params["xyz"].device
            seen = {}
            for cam, scale in views:
                key = (cam["id"], scale)
                if key not in seen:
                    seen[key] = view_work(ctx["model"], params, cam, scale, device)
            ctx["_work"] = [seen[(cam["id"], scale)] for cam, scale in views]
            del params
    return ctx["_work"]
