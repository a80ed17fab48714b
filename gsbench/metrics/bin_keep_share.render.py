"""Percent of K1's (Gaussian, tile) candidates that its tile cull keeps in
the render cell: 100 x the program's counter ``gs.entries`` (the entries
after the cull) over ``gs.rect_tiles`` (the sum of every Gaussian's rect
tiles), both counted in ``ops/binning.py`` ``bin_gaussians`` over the traced
window's frames."""

from gsbench import spans


def read(ctx):
    entries = spans.counter(ctx, "render", "gs.entries")
    tiles = spans.counter(ctx, "render", "gs.rect_tiles")
    return None if entries is None or not tiles else 100.0 * entries / tiles
