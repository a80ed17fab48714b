"""Device milliseconds a Scaffold-GS training step of ``gs.scaffold.decode``,
the neural decode of every anchor's k Gaussians and the live-row compaction
(``pipelines/train_scaffold.py`` ``decode_scaffold``, called by
``train_step_scaffold``): the program's CUDA events around it, over the
traced window's training steps."""

from gsbench import spans


def read(ctx):
    return spans.device_ms(ctx, "train_scaffold", "gs.scaffold.decode")
