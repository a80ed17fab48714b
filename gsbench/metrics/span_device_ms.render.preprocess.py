"""Device milliseconds a frame of ``gs.preprocess``, preprocess with SH
(``ops/gaussian.py`` ``preprocess``): the program's CUDA events around it,
over the traced window's frames."""

from gsbench import spans


def read(ctx):
    return spans.device_ms(ctx, "render", "gs.preprocess")
