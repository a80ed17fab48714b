"""Device milliseconds a Scaffold-GS training step of ``gs.adam``, the
statistics and the shared-count Adam over the anchors and the heads
(``train_step_scaffold``): the program's CUDA events around it, over the
traced window's training steps."""

from gsbench import spans


def read(ctx):
    return spans.device_ms(ctx, "train_scaffold", "gs.adam")
