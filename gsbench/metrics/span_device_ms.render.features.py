"""Device milliseconds a frame of ``gs.features``, the SH coefficients' assembly
(``models/vanilla.py`` ``get_features``): the program's CUDA events around it,
over the traced window's frames."""

from gsbench import spans


def read(ctx):
    return spans.device_ms(ctx, "render", "gs.features")
