"""Device milliseconds a training step of ``gs.composite``, the compositor
forward (K3, ``ops/composite.py``): the program's CUDA events around it, over
the traced window's training steps."""

from gsbench import spans


def read(ctx):
    return spans.device_ms(ctx, "train", "gs.composite")
