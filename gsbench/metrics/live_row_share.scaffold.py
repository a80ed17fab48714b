"""Percent of the decoded neural Gaussians that the Scaffold-GS step
rasterizes: 100 x the program's counter ``gs.scaffold.live`` (the rows of
positive decoded opacity) over ``gs.scaffold.rows`` (anchors x k), both
counted in ``pipelines/train_scaffold.py`` ``train_step_scaffold`` over the
traced window's steps."""

from gsbench import spans


def read(ctx):
    live = spans.counter(ctx, "train_scaffold", "gs.scaffold.live")
    rows = spans.counter(ctx, "train_scaffold", "gs.scaffold.rows")
    return None if live is None or not rows else 100.0 * live / rows
