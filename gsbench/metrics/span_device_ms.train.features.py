"""Device milliseconds a training step of ``gs.features``, the SH coefficients'
assembly (``pipelines/train.py`` ``_features``, a ``torch.cat`` of every
Gaussian's bands): the program's CUDA events around it, over the traced
window's training steps."""

from gsbench import spans


def read(ctx):
    return spans.device_ms(ctx, "train", "gs.features")
