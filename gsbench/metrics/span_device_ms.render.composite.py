"""Device milliseconds a frame of ``gs.composite``, the compositor (K3,
``ops/composite.py``): the program's CUDA events around it, over the traced
window's frames."""

from gsbench import spans


def read(ctx):
    return spans.device_ms(ctx, "render", "gs.composite")
