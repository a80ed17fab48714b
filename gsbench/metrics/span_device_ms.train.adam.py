"""Device milliseconds a training step of ``gs.adam``, the densification
statistics and ``adam_update`` in ``optimise``: the program's CUDA events
around it, over the traced window's training steps."""

from gsbench import spans


def read(ctx):
    return spans.device_ms(ctx, "train", "gs.adam")
