"""Device milliseconds a training step of ``gs.preprocess``, preprocess with SH
(``ops/gaussian.py`` ``preprocess``, called by ``ops/rasterize.py``): the
program's CUDA events around it, over the traced window's training steps."""

from gsbench import spans


def read(ctx):
    return spans.device_ms(ctx, "train", "gs.preprocess")
