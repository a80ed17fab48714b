"""Device milliseconds a Scaffold-GS training step of ``gs.preprocess``,
preprocess of the live rows with their decoded colours (``ops/gaussian.py``
``preprocess``, called by ``ops/rasterize.py``): the program's CUDA events
around it, over the traced window's training steps."""

from gsbench import spans


def read(ctx):
    return spans.device_ms(ctx, "train_scaffold", "gs.preprocess")
